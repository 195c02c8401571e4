"""Offline data-prep pipeline (L0): raw archives -> windowed pickles
(counterpart of the JAX package's ``data/prep.py``, which uses no JAX).

Capability of the reference ``3_stream/`` scripts, as library functions
instead of run-once scripts, and a CLI (``python -m
fall_multimodal_tpu_torch.data.prep``, :func:`main`):

* :func:`extract_archives` — unpack HAR-UP subject zips
  (``har_unzip_pre.py`` / ``har_unzip.py``);
* :func:`frames_to_video` — PNG frame dirs -> 30fps video
  (``har_create1.py:42-70``; requires OpenCV, gated);
* :func:`build_annotation_csv` — per-frame ``(video, frame, label)`` rows
  (``har_create2.py:28-47``);
* :func:`normalize_points_with_size` + :class:`PoseExtractor` — the pose
  stage's math and interface (``har_create3.py:53-58``); the detector/pose
  networks themselves are external pretrained models (TinyYOLOv3 + SPPE
  FastPose) that were never part of the reference repo either — any callable
  producing per-frame (13, 3) keypoints plugs in;
* :func:`normalize_sensor_csv` / :func:`join_pose_and_sensor` — HAR-UP
  sensor CSV header repair, column renaming, accelerometer selection, and
  the pose-CSV join (``har_sensor.ipynb:4-5``, ``har_create4_sensor.py:84-96``);
* :func:`build_windowed_dataset` — the full label/window builder: NaN
  filter, one-hot, epsilon + sequential label smoothing, continuity
  segmentation, scale-pose, center joint, score-weighted labels, stride-1
  windows, pickle output (``har_create4_sensor.py:82-147``).

Everything here is numpy on the host; pandas (the CSV stages) and OpenCV
(:func:`frames_to_video`) are imported by the functions that need them, so
importing this module needs neither, and a missing one raises an
``ImportError`` naming the package and the function. The pickles equal the
JAX package's byte for byte on the same inputs and load through
:func:`~fall_multimodal_tpu_torch.data.loaders.load_pickle_windows`.
"""

from __future__ import annotations

import importlib
import os
import pickle
import zipfile
from typing import Dict, List, Optional, Protocol, Sequence, Tuple

import numpy as np

from fall_multimodal_tpu_torch.data.preprocess import (
    add_center_joint,
    epsilon_smooth,
    scale_pose,
    score_weighted_labels,
    segment_continuous,
    seq_label_smoothing,
    window_video,
)
from fall_multimodal_tpu_torch.data.synthetic import WindowedDataset

# The 15 HAR-UP accelerometer channels the reference selects
# (har_create4_sensor.py:88-92).
HARUP_ACCEL_COLUMNS: Tuple[str, ...] = tuple(
    f"{site}Accelerometer_{axis}-axis (g)"
    for site in ("Ankle", "RightPocket", "Belt", "Neck", "Wrist")
    for axis in ("x", "y", "z")
)


def _require(package: str, function: str, why: str = ""):
    """``package``, imported for ``function``; a clear ``ImportError`` when it
    is not installed."""
    try:
        return importlib.import_module(package)
    except ImportError as e:
        raise ImportError(f"{function} needs the package {package!r}, which is not "
                          f"installed here{why}") from e


def extract_archives(src_dir: str, dst_dir: str) -> List[str]:
    """Unpack every ``*.zip`` under ``src_dir`` into ``dst_dir``."""
    extracted = []
    os.makedirs(dst_dir, exist_ok=True)
    for root, _, files in os.walk(src_dir):
        for f in sorted(files):
            if f.endswith(".zip"):
                with zipfile.ZipFile(os.path.join(root, f)) as zf:
                    zf.extractall(dst_dir)
                extracted.append(f)
    return extracted


def frames_to_video(
    frame_dir: str,
    out_path: str,
    fps: int = 30,
    size: Tuple[int, int] = (320, 240),
) -> str:
    """Assemble sorted PNG frames into a video (needs OpenCV)."""
    cv2 = _require("cv2", "frames_to_video",
                   " (OpenCV); the downstream pipeline consumes pose CSVs, so this stage "
                   "is only needed to re-create videos from raw frame dumps")
    frames = sorted(
        os.path.join(frame_dir, f)
        for f in os.listdir(frame_dir)
        if f.lower().endswith((".png", ".jpg"))
    )
    writer = cv2.VideoWriter(
        out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, size
    )
    for path in frames:
        img = cv2.imread(path)
        writer.write(cv2.resize(img, size))
    writer.release()
    return out_path


def build_annotation_csv(
    frame_labels: Dict[str, Sequence[Tuple[int, object]]],
    out_csv: Optional[str] = None,
):
    """Per-frame annotation table: {video: [(frame, label), ...]} ->
    DataFrame(video, frame, label) (``har_create2.py:28-47``)."""
    pd = _require("pandas", "build_annotation_csv")

    rows = [
        {"video": video, "frame": frame, "label": label}
        for video, pairs in frame_labels.items()
        for frame, label in pairs
    ]
    df = pd.DataFrame(rows, columns=["video", "frame", "label"])
    if out_csv:
        df.to_csv(out_csv, index=False)
    return df


def normalize_points_with_size(
    points: np.ndarray, width: float, height: float, flip: bool = False
) -> np.ndarray:
    """Normalize (x, y) keypoints by frame size into [0, 1]
    (``har_create3.py:53-58``)."""
    pts = points.copy().astype(np.float64)
    pts[..., 0] /= width
    pts[..., 1] /= height
    if flip:
        pts[..., 0] = 1.0 - pts[..., 0]
    return pts


class PoseExtractor(Protocol):
    """Interface of the pose stage: frame -> (J, 3) keypoints or None.

    The reference wires TinyYOLOv3 (person detector) + SPPE FastPose
    (``har_create3.py:37-42``) — external pretrained models outside the
    repo. Any callable with this shape plugs into :func:`extract_pose_csv`.
    """

    def __call__(self, frame: np.ndarray) -> Optional[np.ndarray]: ...


def extract_pose_csv(
    frames: Sequence[np.ndarray],
    extractor: PoseExtractor,
    video_name: str,
    labels: Optional[Sequence[object]] = None,
    frame_size: Optional[Tuple[float, float]] = None,
    save_path: Optional[str] = None,
):
    """Single-callable convenience wrapper over :func:`run_pose_extraction`.

    For users with one fused frame->keypoints model instead of the
    reference's detector+pose pair: the callable's (J, 3) pixel-coordinate
    output (or None on a miss) is adapted into the two-stage driver, so
    both entry points emit the SAME reference-exact ``POSE_CSV_COLUMNS``
    schema (1-based frames, coordinates normalized by frame size,
    ``har_create3.py:45-50,181-185``)."""

    def full_frame_detector(frame: np.ndarray):
        h, w = frame.shape[:2]
        return np.array([[0, 0, w, h]])

    def pose_from_extractor(frame: np.ndarray, box: np.ndarray):
        pts = extractor(frame)
        if pts is None:
            return None
        pts = np.asarray(pts, dtype=np.float64)
        return {"keypoints": pts[:, :2], "kp_score": pts[:, 2:3]}

    return run_pose_extraction(
        frames,
        full_frame_detector,
        pose_from_extractor,
        video_name,
        labels=labels,
        frame_size=frame_size,
        box_pad=0,
        save_path=save_path,
    )


# The reference's exact 13-joint pose-CSV schema (har_create3.py:45-50).
POSE_JOINT_NAMES: Tuple[str, ...] = (
    "Nose", "LShoulder", "RShoulder", "LElbow", "RElbow", "LWrist", "RWrist",
    "LHip", "RHip", "LKnee", "RKnee", "LAnkle", "RAnkle",
)
POSE_CSV_COLUMNS: Tuple[str, ...] = tuple(
    ["video", "frame"]
    + [f"{j}_{ax}" for j in POSE_JOINT_NAMES for ax in ("x", "y", "s")]
    + ["label"]
)


class PersonDetector(Protocol):
    """Person-detection stage: frame -> (K, >=4) xyxy boxes (best first) or
    None when nothing is detected (the reference's TinyYOLOv3_onecls,
    ``har_create3.py:37,130-135``)."""

    def __call__(self, frame: np.ndarray) -> Optional[np.ndarray]: ...


class PoseEstimatorProtocol(Protocol):
    """Pose stage: (frame, xyxy box) -> dict with ``keypoints`` (13, 2) and
    ``kp_score`` (13, 1), or None (the reference's SPPE_FastPose.predict,
    ``har_create3.py:42,142-144``)."""

    def __call__(
        self, frame: np.ndarray, box: np.ndarray
    ) -> Optional[Dict[str, np.ndarray]]: ...


def run_pose_extraction(
    frames: Sequence[np.ndarray],
    detector: PersonDetector,
    pose_estimator: PoseEstimatorProtocol,
    video_name: str,
    labels: Optional[Sequence[object]] = None,
    frame_size: Optional[Tuple[float, float]] = None,
    pick: str = "first",
    box_pad: int = 5,
    save_path: Optional[str] = None,
):
    """The per-frame detection+pose driver of ``har_create3.py:64-186``.

    Per frame: detect persons; a miss yields a zero box and therefore an
    all-NaN keypoint row (``bb = np.zeros(4)`` -> ``bb.any() == 0`` -> no
    pose call). A hit picks one detection (``pick="first"`` — the
    reference's ``detect(frame)[0, :4]``, its detector sorts by score —
    or ``"largest"`` by box area for unsorted detectors), pads the box by
    ``box_pad`` px clipped to the frame, runs the pose estimator, and
    normalizes keypoints by frame size into [0, 1]. Rows use the
    reference's exact 41-column CSV schema (1-based frame index); with
    ``save_path`` the per-video table is appended reference-style (header
    written only when the file is new, ``har_create3.py:181-185``).
    """
    pd = _require("pandas", "run_pose_extraction")

    n_joints = len(POSE_JOINT_NAMES)
    rows = []
    for i, frame in enumerate(frames):
        width, height = (
            frame_size
            if frame_size is not None
            else (frame.shape[1], frame.shape[0])
        )
        detections = detector(frame)
        if detections is None or len(detections) == 0:
            bb = np.zeros(4, dtype=int)
        else:
            detections = np.asarray(detections)
            if pick == "largest":
                areas = (detections[:, 2] - detections[:, 0]) * (
                    detections[:, 3] - detections[:, 1]
                )
                best = int(np.argmax(areas))
            else:
                best = 0
            bb = detections[best, :4].astype(int)
        bb = bb.copy()
        bb[:2] = np.maximum(0, bb[:2] - box_pad)
        if bb[2:].any():
            bb[2:] = np.minimum([width, height], bb[2:] + box_pad)

        result = pose_estimator(frame, bb) if bb.any() else None
        label = labels[i] if labels is not None else 0
        if result is not None:
            pts = normalize_points_with_size(
                np.asarray(result["keypoints"], dtype=np.float64), width, height
            )
            scores = np.asarray(result["kp_score"], dtype=np.float64).reshape(-1, 1)
            pt_norm = np.concatenate([pts, scores], axis=1)
            rows.append([video_name, i + 1, *pt_norm.flatten().tolist(), label])
        else:
            rows.append([video_name, i + 1, *([np.nan] * (n_joints * 3)), label])

    df = pd.DataFrame(rows, columns=list(POSE_CSV_COLUMNS))
    if save_path:
        if os.path.exists(save_path):
            df.to_csv(save_path, mode="a", header=False, index=False)
        else:
            df.to_csv(save_path, mode="w", index=False)
    return df


def normalize_sensor_csv(path_or_df, accel_columns=HARUP_ACCEL_COLUMNS):
    """Repair a HAR-UP sensor CSV: collapse the 2-row header into
    ``Site_measure`` names and keep the accelerometer channels
    (``har_sensor.ipynb:4``). Accepts a path or a raw 2-header DataFrame."""
    pd = _require("pandas", "normalize_sensor_csv")

    if isinstance(path_or_df, str):
        df = pd.read_csv(path_or_df, header=[0, 1])
    else:
        df = path_or_df
    if isinstance(df.columns, pd.MultiIndex):
        site = None
        names = []
        for top, sub in df.columns:
            if not str(top).startswith("Unnamed"):
                site = str(top).strip()
            names.append(
                str(sub).strip() if site in (None, "")
                else f"{site}_{str(sub).strip()}"
            )
        df = df.copy()
        df.columns = names
    keep = [c for c in df.columns if c in accel_columns or c in
            ("TimeStamps", "Subject", "Activity")]
    return df[keep]


def join_pose_and_sensor(pose_df, sensor_df, accel_columns=None):
    """Row-align sensor channels onto the pose table
    (``har_create4_sensor.py:84-96``). ``accel_columns`` restricts the
    joined sensor channels (default: every non-meta column, as the
    reference joins whatever ``normalize_sensor_csv`` kept)."""
    pd = _require("pandas", "join_pose_and_sensor")

    sensor = sensor_df.drop(
        columns=[c for c in ("TimeStamps", "Subject", "Activity")
                 if c in sensor_df.columns]
    ).reset_index(drop=True)
    if accel_columns is not None:
        missing = [c for c in accel_columns if c not in sensor.columns]
        if missing:
            raise KeyError(f"sensor CSV lacks requested columns: {missing}")
        sensor = sensor[list(accel_columns)]
    return pd.concat([pose_df.reset_index(drop=True), sensor], axis=1)


def build_windowed_dataset(
    annot_df,
    n_frames: int = 30,
    smooth_labels_step: int = 8,
    label_eps: float = 0.1,
    sensor_columns: Optional[Sequence[str]] = None,
    add_center: bool = True,
    out_pickle: Optional[str] = None,
) -> WindowedDataset:
    """The full window/labels builder (``har_create4_sensor.py:82-147``).

    ``annot_df`` columns: video, frame, <13 joints x (x, y, score)>, label
    [, sensor channels]. Per video: NaN rows dropped, labels one-hot then
    epsilon- and sequence-smoothed, rows segmented at frame gaps >= 10,
    pose scale-normalized per frame, center joint appended, labels weighted
    by boosted mean keypoint score, stride-1 windows of ``n_frames`` with
    mean window labels. Output matches the reference pickle tuple layout.
    """
    pd = _require("pandas", "build_windowed_dataset")

    sensor_columns = list(sensor_columns or [])
    label_onehot = pd.get_dummies(annot_df["label"]).astype(float)
    classes = list(label_onehot.columns)
    df = pd.concat([annot_df.drop(columns=["label"]), label_onehot], axis=1)

    joint_cols = [
        c for c in df.columns
        if c not in ["video", "frame"] + classes + sensor_columns
    ]
    n_joints = len(joint_cols) // 3

    videos, feats, sens, labs = [], [], [], []
    for vid, vdf in df.groupby("video", sort=False):
        vdf = vdf.reset_index(drop=True)
        # NaN filter: the reference filters pose NaNs (har_create4.py:30-32);
        # sensor columns are filtered too so a short/misaligned sensor join
        # cannot push NaN windows into training (NaN loss at epoch 1 with no
        # hint of the data cause)
        vdf = vdf[
            ~vdf[joint_cols + sensor_columns].isna().any(axis=1)
        ].reset_index(drop=True)
        if len(vdf) < n_frames + 1:
            continue

        labels = vdf[classes].to_numpy(float)
        labels = epsilon_smooth(labels, label_eps)
        labels = seq_label_smoothing(labels, smooth_labels_step)

        frames = vdf["frame"].to_numpy()
        for seg in segment_continuous(frames, max_gap=10):
            if len(seg) < n_frames + 1:
                continue
            pose = np.ascontiguousarray(
                vdf.iloc[seg][joint_cols].to_numpy(float)
            ).reshape(-1, n_joints, 3)
            pose[:, :, :2] = scale_pose(pose[:, :, :2])
            if add_center:
                pose = add_center_joint(pose)
            seg_labels = score_weighted_labels(
                labels[seg], pose[:, :, 2], has_center=add_center
            )
            sensor = (
                vdf.iloc[seg][sensor_columns].to_numpy(float)
                if sensor_columns else None
            )
            out = window_video(pose, seg_labels, n_frames, sensor=sensor)
            feats.append(out[0])
            labs.append(out[1])
            if sensor_columns:
                sens.append(out[2])
            videos.extend([vid] * len(out[0]))

    if not feats:  # every segment too short after NaN/gap filtering
        n_j = n_joints + (1 if add_center else 0)
        data = WindowedDataset(
            features=np.zeros((0, n_frames, n_j, 3), np.float32),
            labels=np.zeros((0, len(classes)), np.float32),
            sensors=(
                np.zeros((0, n_frames, len(sensor_columns)), np.float32)
                if sensor_columns else None
            ),
            videos=np.asarray([], dtype=str),
        )
    else:
        data = WindowedDataset(
            features=np.concatenate(feats).astype(np.float32),
            labels=np.concatenate(labs).astype(np.float32),
            sensors=(
                np.concatenate(sens).astype(np.float32) if sensor_columns else None
            ),
            videos=np.asarray(videos),
        )
    if out_pickle:
        with open(out_pickle, "wb") as fh:
            pickle.dump(
                (list(data.videos), data.features, data.sensors, data.labels)
                if sensor_columns
                else (list(data.videos), data.features, data.labels),
                fh,
            )
    return data


def cross_subject_folds(
    subject_files: Sequence[str], n_folds: int = 5, seed: int = 42
) -> List[Dict[str, List[str]]]:
    """K-fold over subject pickle files (the notebook's
    ``k_fold_cross_subject_HAR_UP``, ``GSTCAN_HAR_sensor(cnn).ipynb:18``)."""
    files = list(subject_files)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(files))
    chunks = np.array_split(perm, n_folds)
    folds = []
    for held in chunks:
        test = [files[i] for i in held]
        train = [f for f in files if f not in test]
        folds.append({"train": train, "test": test})
    return folds


def main(argv=None):
    """Run-once prep pipeline CLI — the capability of the reference's
    ``3_stream/har_*.py`` scripts as subcommands:

        python -m fall_multimodal_tpu_torch.data.prep unzip --src Z --dst D
        python -m fall_multimodal_tpu_torch.data.prep videos --frames-dir F --out V.avi
        python -m fall_multimodal_tpu_torch.data.prep sensor-normalize --src raw.csv --out s.csv
        python -m fall_multimodal_tpu_torch.data.prep join --pose p.csv --sensor s.csv --out j.csv
        python -m fall_multimodal_tpu_torch.data.prep windows --annot j.csv --out data.pkl \
            [--seq-len 30] [--sensor-columns c1,c2] [--no-center] \
            [--smooth-step 8] [--label-eps 0.1]
    """
    import argparse

    p = argparse.ArgumentParser(prog="fall_multimodal_tpu_torch.data.prep",
                                description="offline data-prep pipeline")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("unzip", help="extract HAR-UP subject archives")
    s.add_argument("--src", required=True)
    s.add_argument("--dst", required=True)

    s = sub.add_parser("videos", help="assemble PNG frames into a video")
    s.add_argument("--frames-dir", required=True)
    s.add_argument("--out", required=True)
    s.add_argument("--fps", type=int, default=30)

    s = sub.add_parser("sensor-normalize",
                       help="fix HAR-UP 2-row sensor headers, select accel columns")
    s.add_argument("--src", required=True)
    s.add_argument("--out", required=True)

    s = sub.add_parser("join", help="join pose CSV with normalized sensor CSV")
    s.add_argument("--pose", required=True)
    s.add_argument("--sensor", required=True)
    s.add_argument("--out", required=True)

    s = sub.add_parser("windows",
                       help="annotation(+pose[+sensor]) CSV -> windowed pickle")
    s.add_argument("--annot", required=True)
    s.add_argument("--out", required=True)
    s.add_argument("--seq-len", type=int, default=30)
    s.add_argument("--sensor-columns", default=None,
                   help="comma-separated sensor column names "
                        "('harup' = the 15 HAR-UP accel columns)")
    s.add_argument("--no-center", action="store_true",
                   help="skip the 14th midpoint center joint")
    s.add_argument("--smooth-step", type=int, default=8)
    s.add_argument("--label-eps", type=float, default=0.1)

    args = p.parse_args(argv)
    if args.cmd == "unzip":
        out = extract_archives(args.src, args.dst)
        print(f"extracted {len(out)} archives into {args.dst}")
        return out
    if args.cmd == "videos":
        out = frames_to_video(args.frames_dir, args.out, fps=args.fps)
        print(f"wrote {out}")
        return out
    pd = _require("pandas", f"prep {args.cmd}")
    if args.cmd == "sensor-normalize":
        df = normalize_sensor_csv(args.src)
        df.to_csv(args.out, index=False)
        print(f"wrote {args.out} ({len(df)} rows, {len(df.columns)} cols)")
        return df
    if args.cmd == "join":
        joined = join_pose_and_sensor(
            pd.read_csv(args.pose), pd.read_csv(args.sensor)
        )
        joined.to_csv(args.out, index=False)
        print(f"wrote {args.out} ({len(joined)} rows)")
        return joined
    # windows
    cols = args.sensor_columns
    if cols == "harup":
        cols = list(HARUP_ACCEL_COLUMNS)
    elif cols:
        cols = [c.strip() for c in cols.split(",") if c.strip()]
    data = build_windowed_dataset(
        pd.read_csv(args.annot),
        n_frames=args.seq_len,
        smooth_labels_step=args.smooth_step,
        label_eps=args.label_eps,
        sensor_columns=cols,
        add_center=not args.no_center,
        out_pickle=args.out,
    )
    print(
        f"wrote {args.out}: {len(data)} windows, "
        f"{data.features.shape[2]} joints, "
        f"{data.labels.shape[1]} classes"
        + (f", sensor dim {data.sensors.shape[2]}" if data.sensors is not None else "")
    )
    return data


if __name__ == "__main__":
    main()
