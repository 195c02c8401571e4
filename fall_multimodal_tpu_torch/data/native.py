"""ctypes bindings for the native window slicer, with a numpy version of the
same semantics (counterpart of the JAX package's ``data/native.py``).

Stride-1 window slicing over per-video CSV rows is the one hot host loop of
dataset ingestion (the reference did it in python/pandas,
``Multimodal_Fall3/dataloader.py:51-56``). ``native/window_slicer.cpp`` at
the repository root does it in C++ behind a C ABI. This module compiles it
with ``g++ -O3 -shared -fPIC -std=c++17`` at first use into ``data/_build/``
(listed in ``.gitignore``; the library's name carries a hash of the source
and the flags), loads it with ctypes, and takes the numpy path when no
compiler is there. :func:`native_available` says which path runs. This is a
host routine, not a card kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "native", "window_slicer.cpp")
BUILD_DIR = os.path.join(_HERE, "_build")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_state = {"tried": False, "lib": None}


def library_path() -> str:
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as fh:
        digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"window_slicer-{digest.hexdigest()[:16]}.so")


def _build_library() -> Optional[str]:
    if not os.path.exists(SOURCE):
        return None
    so_path = library_path()
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    # compile to a name of this process, then rename into place: two
    # processes building at once must not interleave writes into one file
    tmp_path = f"{so_path}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *GXX_FLAGS, SOURCE, "-o", tmp_path], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp_path, so_path)
    except (OSError, subprocess.SubprocessError):
        try:
            os.unlink(tmp_path)
        except OSError:
            pass
        return None
    return so_path


def _load() -> Optional[ctypes.CDLL]:
    with _lock:
        if _state["tried"]:
            return _state["lib"]
        _state["tried"] = True
        so_path = _build_library()
        if so_path is None:
            return None
        try:
            lib = ctypes.CDLL(so_path)
        except OSError:
            return None
        i64 = ctypes.c_int64
        f32p = ctypes.POINTER(ctypes.c_float)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.fm_count_windows.restype = i64
        lib.fm_count_windows.argtypes = [f32p, i64, i64, i64p, i64, ctypes.c_int]
        lib.fm_slice_windows.restype = i64
        lib.fm_slice_windows.argtypes = [f32p, i64, i64, i64p, i64, ctypes.c_int, f32p, i64p]
        lib.fm_window_mean_labels.restype = None
        lib.fm_window_mean_labels.argtypes = [f32p, i64, i64, i64p, i64, i64, f32p]
        _state["lib"] = lib
        return lib


def native_available() -> bool:
    """True when the C++ slicer is built and loaded (the numpy path runs
    otherwise)."""
    return _load() is not None


def _as_f32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def slice_windows_numpy(data: np.ndarray, video_codes: np.ndarray, seq_len: int,
                        include_last: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Windows that stay within one video and contain no NaN; returns
    ``(windows (W, seq_len, F), start_rows (W,))``.

    ``include_last=False`` drops each video's final full window (the Gen-1/2
    per-video ``range(n - seq_len)`` convention, ``har_create4.py:125``): a
    window is kept only if the row after its end exists in the same video.
    """
    if seq_len < 1:
        raise ValueError(f"seq_len must be >= 1, got {seq_len}")
    n = len(data)
    count = n - seq_len + 1
    if count <= 0:
        return (np.zeros((0, seq_len, data.shape[1]), np.float32),
                np.zeros((0,), np.int64))
    starts = np.arange(count)
    same_video = video_codes[starts] == video_codes[starts + seq_len - 1]
    if not include_last:
        nxt = starts + seq_len
        next_in_video = (nxt < n) & (video_codes[np.minimum(nxt, n - 1)] == video_codes[starts])
        same_video = same_video & next_in_video
    has_nan = np.isnan(data).any(axis=1)
    nan_prefix = np.concatenate([[0], np.cumsum(has_nan)])
    clean = (nan_prefix[starts + seq_len] - nan_prefix[starts]) == 0
    keep = starts[same_video & clean]
    view = np.lib.stride_tricks.sliding_window_view(data, seq_len, axis=0)
    windows = np.ascontiguousarray(np.moveaxis(view, -1, 1)[keep], np.float32)
    return windows, keep.astype(np.int64)


def slice_windows(data: np.ndarray, video_codes: np.ndarray, seq_len: int,
                  include_last: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Per-video stride-1 windows with NaN rejection (native when built)."""
    if seq_len < 1:
        raise ValueError(f"seq_len must be >= 1, got {seq_len}")
    lib = _load()
    if lib is None:
        return slice_windows_numpy(data, video_codes, seq_len, include_last)
    data = _as_f32(data)
    codes = np.ascontiguousarray(video_codes, dtype=np.int64)
    if data.ndim != 2 or codes.shape != (data.shape[0],):
        raise ValueError(f"slice_windows wants data (rows, cols) and one code per row, got "
                         f"{data.shape} and {codes.shape}")
    n_rows, n_cols = data.shape
    i64 = ctypes.c_int64
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    count = lib.fm_count_windows(data.ctypes.data_as(f32p), i64(n_rows), i64(n_cols),
                                 codes.ctypes.data_as(i64p), i64(seq_len), int(include_last))
    out = np.empty((count, seq_len, n_cols), np.float32)
    starts = np.empty((count,), np.int64)
    written = lib.fm_slice_windows(data.ctypes.data_as(f32p), i64(n_rows), i64(n_cols),
                                   codes.ctypes.data_as(i64p), i64(seq_len), int(include_last),
                                   out.ctypes.data_as(f32p), starts.ctypes.data_as(i64p))
    if written != count:
        # a count/slice disagreement would return uninitialised rows
        raise RuntimeError(f"native slicer wrote {written} windows but counted {count}")
    return out, starts


def window_mean_labels(labels: np.ndarray, start_rows: np.ndarray,
                       seq_len: int) -> np.ndarray:
    """Mean label row over each window (native when built)."""
    lib = _load()
    labels = _as_f32(labels)
    starts = np.ascontiguousarray(start_rows, dtype=np.int64)
    if len(starts) and (starts.min() < 0 or starts.max() + seq_len > len(labels)):
        raise ValueError(f"window starts run past the {len(labels)} label rows")
    if lib is None:
        if not len(starts):
            return np.zeros((0, labels.shape[1]), np.float32)
        return np.stack([labels[s: s + seq_len].mean(axis=0) for s in starts])
    out = np.empty((len(starts), labels.shape[1]), np.float32)
    i64 = ctypes.c_int64
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.fm_window_mean_labels(labels.ctypes.data_as(f32p), i64(labels.shape[0]),
                              i64(labels.shape[1]), starts.ctypes.data_as(i64p),
                              i64(len(starts)), i64(seq_len), out.ctypes.data_as(f32p))
    return out
