"""The port's offline prep pipeline (``data/prep.py``) against the JAX
package's on the same inputs, on the CPU: the cases of
``tests/test_prep.py``, each run through both modules. Arrays and tables
must be equal exactly (``np.array_equal``, ``assert_frame_equal``), the
pickles and CSVs the two write byte for byte; the port's pickles load
through the port's ``load_pickle_windows``. The OpenCV cases skip where
``cv2`` is not installed, as the JAX package's do."""

import os
import subprocess
import sys
import zipfile

import numpy as np
import pandas as pd
import pytest

from fall_multimodal_tpu.data import prep as jax_prep
from fall_multimodal_tpu_torch.data import load_pickle_windows
from fall_multimodal_tpu_torch.data import prep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACCEL = list(prep.HARUP_ACCEL_COLUMNS)


def _synthetic_annot(rng, n_videos=2, frames_per_video=80, n_joints=13,
                     classes=("Fall", "Walk")):
    rows = []
    for v in range(n_videos):
        cls_seq = [classes[(v + (f // 40)) % len(classes)] for f in range(frames_per_video)]
        for f in range(frames_per_video):
            row = {"video": f"vid{v}", "frame": f, "label": cls_seq[f]}
            for j in range(n_joints):
                row[f"j{j}_x"] = rng.random() * 320
                row[f"j{j}_y"] = rng.random() * 240
                row[f"j{j}_s"] = 0.5 + 0.5 * rng.random()
            for c in ACCEL:
                row[c] = rng.normal()
            rows.append(row)
    return pd.DataFrame(rows)


def _same_windows(a, b):
    for key in ("features", "labels", "sensors", "videos"):
        x, y = getattr(a, key), getattr(b, key)
        assert (x is None) == (y is None), key
        if x is not None:
            assert x.dtype == y.dtype and np.array_equal(x, y), key


def _bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_module_constants_are_the_jax_package_s():
    assert prep.HARUP_ACCEL_COLUMNS == jax_prep.HARUP_ACCEL_COLUMNS
    assert prep.POSE_JOINT_NAMES == jax_prep.POSE_JOINT_NAMES
    assert prep.POSE_CSV_COLUMNS == jax_prep.POSE_CSV_COLUMNS


@pytest.mark.parametrize("case", ["sensor", "pose_only", "no_center", "nan_pose",
                                  "nan_sensor", "all_short"])
def test_windowed_dataset_and_pickle_equal_the_jax_package_s(case, tmp_path, rng):
    annot = _synthetic_annot(rng, n_videos=1 if case.startswith("nan") else 2)
    kw = dict(n_frames=30, sensor_columns=ACCEL)
    if case == "pose_only":
        kw["sensor_columns"] = None
    elif case == "no_center":
        kw.update(add_center=False, smooth_labels_step=4, label_eps=0.2)
    elif case == "nan_pose":
        annot.loc[10:20, "j3_x"] = np.nan
    elif case == "nan_sensor":
        annot.loc[len(annot) - 10:, ACCEL[0]] = np.nan
    elif case == "all_short":
        kw["n_frames"] = 90
    ours, theirs = str(tmp_path / "ours.pkl"), str(tmp_path / "theirs.pkl")
    data = prep.build_windowed_dataset(annot.copy(), out_pickle=ours, **kw)
    ref = jax_prep.build_windowed_dataset(annot.copy(), out_pickle=theirs, **kw)
    _same_windows(data, ref)
    assert _bytes(ours) == _bytes(theirs)
    if len(data):
        loaded = load_pickle_windows(ours)
        assert np.array_equal(loaded.features, data.features)
        assert np.array_equal(loaded.labels, data.labels)
        if data.sensors is not None:
            assert np.array_equal(loaded.sensors, data.sensors)
    else:
        assert case == "all_short"


def test_annotation_table_and_csv(tmp_path):
    labels = {"vidA": [(0, "Fall"), (1, "Fall")], "vidB": [(0, "Walk")]}
    ours = prep.build_annotation_csv(labels, out_csv=str(tmp_path / "ours.csv"))
    theirs = jax_prep.build_annotation_csv(labels, out_csv=str(tmp_path / "theirs.csv"))
    pd.testing.assert_frame_equal(ours, theirs)
    assert _bytes(tmp_path / "ours.csv") == _bytes(tmp_path / "theirs.csv")


def test_points_archives_and_folds(tmp_path):
    pts = np.array([[160.0, 120.0], [320.0, 240.0], [13.0, 7.5]])
    for flip in (False, True):
        assert np.array_equal(prep.normalize_points_with_size(pts, 320, 240, flip),
                              jax_prep.normalize_points_with_size(pts, 320, 240, flip))
    src = tmp_path / "src"
    src.mkdir()
    for name in ("subj2.zip", "subj1.zip"):
        with zipfile.ZipFile(src / name, "w") as zf:
            zf.writestr(f"{name[:-4]}/frame0.png", b"fake")
    assert (prep.extract_archives(str(src), str(tmp_path / "a"))
            == jax_prep.extract_archives(str(src), str(tmp_path / "b"))
            == ["subj1.zip", "subj2.zip"])
    assert (tmp_path / "a" / "subj1" / "frame0.png").exists()
    files = [f"subj{i}.pkl" for i in range(10)]
    for n_folds, seed in ((5, 0), (3, 42)):
        assert (prep.cross_subject_folds(files, n_folds, seed)
                == jax_prep.cross_subject_folds(files, n_folds, seed))


def _stub_stages(miss_frames=(), n_joints=13):
    def detector(frame):
        i = int(frame[0, 0, 0])
        if i in miss_frames:
            return None
        return np.array([[10, 20, 110, 220, 0.9], [0, 0, 319, 239, 0.3]])

    def pose(frame, box):
        i = int(frame[0, 0, 0])
        x = np.linspace(box[0], box[2], n_joints)
        y = np.linspace(box[1], box[3], n_joints)
        return {"keypoints": np.stack([x, y], axis=1) + i,
                "kp_score": np.full((n_joints, 1), 0.9)}

    return detector, pose


def _frames(n, w=320, h=240):
    frames = []
    for i in range(n):
        f = np.zeros((h, w, 3), np.uint8)
        f[0, 0, 0] = i
        frames.append(f)
    return frames


@pytest.mark.parametrize("pick,box_pad", [("first", 5), ("largest", 5), ("first", 0)])
def test_pose_extraction_driver(pick, box_pad, tmp_path):
    """Detections, a miss, the pick, the padding, the normalisation, the
    per-video append, and the windows built from the result."""
    detector, pose = _stub_stages(miss_frames={7})
    labels = [0] * 40 + [1] * 35
    out = {}
    for name, module in (("ours", prep), ("theirs", jax_prep)):
        path = str(tmp_path / f"{name}.csv")
        for video, n in (("vid0", 75), ("vid1", 40)):
            df = module.run_pose_extraction(_frames(n), detector, pose, video,
                                            labels=labels[:n], pick=pick, box_pad=box_pad,
                                            save_path=path)
        out[name] = (df, path, module.build_windowed_dataset(pd.read_csv(path), n_frames=30))
    pd.testing.assert_frame_equal(out["ours"][0], out["theirs"][0])
    assert _bytes(out["ours"][1]) == _bytes(out["theirs"][1])
    _same_windows(out["ours"][2], out["theirs"][2])
    assert len(out["ours"][2]) > 0


def test_single_callable_extractor(rng):
    points = rng.random((5, 13, 3)) * 100.0
    frames = [np.zeros((240, 320, 3)) for _ in range(5)]
    dfs = []
    for module in (prep, jax_prep):
        calls = iter(points)
        dfs.append(module.extract_pose_csv(frames, lambda f: next(calls), "vid0",
                                           labels=["a"] * 5, frame_size=(320, 240)))
    pd.testing.assert_frame_equal(*dfs)
    missed = [m.extract_pose_csv([np.zeros((240, 320, 3))], lambda f: None, "v")
              for m in (prep, jax_prep)]
    pd.testing.assert_frame_equal(*missed)
    assert np.isnan(missed[0].iloc[0]["Nose_x"])


def _raw_sensor_csv(path, rng, n=20):
    """The HAR-UP sensor CSV's two-row header."""
    sites = [f"{s}Accelerometer" for s in ("Ankle", "RightPocket", "Belt", "Neck", "Wrist")]
    top = ["Time", ""] + sum([[s, "", ""] for s in sites], []) + ["Extra"]
    sub = ["TimeStamps", "Subject"] + ["x-axis (g)", "y-axis (g)", "z-axis (g)"] * 5 + ["a"]
    body = np.concatenate([np.arange(n)[:, None], np.ones((n, 1)),
                           rng.normal(size=(n, 16))], axis=1)
    with open(path, "w") as fh:
        fh.write(",".join(top) + "\n")
        fh.write(",".join(sub) + "\n")
        for row in body:
            fh.write(",".join(str(x) for x in row) + "\n")


def test_sensor_normalisation_and_join(tmp_path, rng):
    path = str(tmp_path / "sensor_raw.csv")
    _raw_sensor_csv(path, rng)
    ours, theirs = prep.normalize_sensor_csv(path), jax_prep.normalize_sensor_csv(path)
    pd.testing.assert_frame_equal(ours, theirs)
    assert len([c for c in ours.columns if c.endswith("(g)")]) == 15
    raw = pd.read_csv(path, header=[0, 1])
    pd.testing.assert_frame_equal(prep.normalize_sensor_csv(raw),
                                  jax_prep.normalize_sensor_csv(raw))
    pose = pd.DataFrame({"video": ["v"] * 20, "frame": range(20)})
    for cols in (None, ACCEL[:3]):
        pd.testing.assert_frame_equal(prep.join_pose_and_sensor(pose, ours, cols),
                                      jax_prep.join_pose_and_sensor(pose, theirs, cols))
    for module in (prep, jax_prep):
        with pytest.raises(KeyError, match="lacks requested columns"):
            module.join_pose_and_sensor(pose, ours, ["nope"])


def _cli_both(args_for):
    """Each package's prep CLI with its own output paths: (ours, theirs)."""
    return prep.main(args_for("ours")), jax_prep.main(args_for("theirs"))


def test_cli_windows_join_and_sensor_normalize(tmp_path, rng):
    annot = _synthetic_annot(rng)
    tables = {"pose_only": annot.drop(columns=ACCEL), "harup": annot,
              "three_channels": annot.drop(columns=ACCEL[3:])}
    for name, table in tables.items():
        table.to_csv(str(tmp_path / f"{name}.csv"), index=False)
    for name, extra in (
            ("pose_only", []), ("harup", ["--sensor-columns", "harup"]),
            ("three_channels", ["--sensor-columns", ",".join(ACCEL[:3]), "--no-center",
                                "--seq-len", "20", "--smooth-step", "3",
                                "--label-eps", "0.05"])):
        ours, theirs = _cli_both(lambda who: [
            "windows", "--annot", str(tmp_path / f"{name}.csv"),
            "--out", str(tmp_path / f"{who}.pkl"), *extra])
        _same_windows(ours, theirs)
        assert _bytes(tmp_path / "ours.pkl") == _bytes(tmp_path / "theirs.pkl")
        assert np.array_equal(load_pickle_windows(str(tmp_path / "ours.pkl")).features,
                              ours.features)
    pose_csv, sensor_csv = str(tmp_path / "pose.csv"), str(tmp_path / "sensor.csv")
    annot.drop(columns=ACCEL).to_csv(pose_csv, index=False)
    annot[["video", "frame"] + ACCEL].to_csv(sensor_csv, index=False)
    ours, theirs = _cli_both(lambda who: [
        "join", "--pose", pose_csv, "--sensor", sensor_csv,
        "--out", str(tmp_path / f"{who}_joined.csv")])
    pd.testing.assert_frame_equal(ours, theirs)
    assert _bytes(tmp_path / "ours_joined.csv") == _bytes(tmp_path / "theirs_joined.csv")
    raw = str(tmp_path / "raw.csv")
    _raw_sensor_csv(raw, rng)
    ours, theirs = _cli_both(lambda who: [
        "sensor-normalize", "--src", raw, "--out", str(tmp_path / f"{who}_s.csv")])
    pd.testing.assert_frame_equal(ours, theirs)
    assert _bytes(tmp_path / "ours_s.csv") == _bytes(tmp_path / "theirs_s.csv")


def test_cli_runs_as_a_module(tmp_path, rng):
    """``python -m fall_multimodal_tpu_torch.data.prep``: unzip, then windows."""
    src = tmp_path / "zips"
    src.mkdir()
    with zipfile.ZipFile(src / "subj1.zip", "w") as zf:
        zf.writestr("camera1/frame0.png", b"fake")
    annot_csv = str(tmp_path / "annot.csv")
    _synthetic_annot(rng, n_videos=1).to_csv(annot_csv, index=False)
    env = dict(os.environ, PYTHONPATH=ROOT)
    for args in (["unzip", "--src", str(src), "--dst", str(tmp_path / "raw")],
                 ["windows", "--annot", annot_csv, "--out", str(tmp_path / "d.pkl"),
                  "--sensor-columns", "harup"]):
        res = subprocess.run([sys.executable, "-m", "fall_multimodal_tpu_torch.data.prep",
                              *args], cwd=ROOT, env=env, capture_output=True, text=True,
                             timeout=120)
        assert res.returncode == 0, res.stderr
    assert "50 windows, 14 joints, 2 classes, sensor dim 15" in res.stdout
    assert len(load_pickle_windows(str(tmp_path / "d.pkl"))) == 50


def test_import_needs_neither_pandas_nor_opencv():
    """With pandas and cv2 hidden the module imports, and each function that
    needs one names the package and itself."""
    code = r"""
import sys
sys.modules["pandas"] = None
sys.modules["cv2"] = None
from fall_multimodal_tpu_torch.data import prep
for call in (lambda: prep.build_annotation_csv({}), lambda: prep.frames_to_video("x", "y"),
             lambda: prep.main(["join", "--pose", "a", "--sensor", "b", "--out", "c"])):
    try:
        call()
    except ImportError as e:
        print("ERR", e)
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    errors = [line for line in res.stdout.splitlines() if line.startswith("ERR")]
    assert len(errors) == 3
    assert "build_annotation_csv needs the package 'pandas'" in errors[0]
    assert "frames_to_video needs the package 'cv2'" in errors[1]
    assert "prep join needs the package 'pandas'" in errors[2]


# ------------------------------------------------------------- video path

def _write_frames(cv2, frames_dir, n, size=(320, 240)):
    os.makedirs(frames_dir, exist_ok=True)
    w, h = size
    for i in range(n):
        img = np.zeros((h, w, 3), np.uint8)
        img[:] = (min(255, i * 20), 60, 200)
        assert cv2.imwrite(os.path.join(frames_dir, f"frame_{i:04d}.png"), img)


def _read_video(cv2, path):
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    fps = cap.get(cv2.CAP_PROP_FPS)
    cap.release()
    return np.stack(frames), fps


@pytest.mark.parametrize("size", [(320, 240), (100, 80)])
def test_frames_to_video_equals_the_jax_package_s(size, tmp_path):
    cv2 = pytest.importorskip("cv2")
    frames_dir = str(tmp_path / "frames")
    _write_frames(cv2, frames_dir, 6, size=size)
    ours = prep.frames_to_video(frames_dir, str(tmp_path / "ours.avi"), fps=30)
    theirs = jax_prep.frames_to_video(frames_dir, str(tmp_path / "theirs.avi"), fps=30)
    (a, fps_a), (b, fps_b) = _read_video(cv2, ours), _read_video(cv2, theirs)
    assert a.shape == (6, 240, 320, 3) and np.array_equal(a, b) and fps_a == fps_b


def test_cli_chain_unzip_videos_windows(tmp_path, rng):
    """zip of frame dumps -> unzip -> videos -> annotation -> windows through
    both CLIs."""
    cv2 = pytest.importorskip("cv2")
    stage = tmp_path / "stage" / "camera1"
    _write_frames(cv2, str(stage), 8)
    src = tmp_path / "zips"
    src.mkdir()
    with zipfile.ZipFile(src / "subj1.zip", "w") as zf:
        for f in sorted(os.listdir(stage)):
            zf.write(stage / f, f"camera1/{f}")
    ours, theirs = _cli_both(lambda who: [
        "unzip", "--src", str(src), "--dst", str(tmp_path / who)])
    assert ours == theirs == ["subj1.zip"]
    ours, theirs = _cli_both(lambda who: [
        "videos", "--frames-dir", str(tmp_path / who / "camera1"),
        "--out", str(tmp_path / f"{who}.avi")])
    assert np.array_equal(_read_video(cv2, ours)[0], _read_video(cv2, theirs)[0])
    annot = prep.build_annotation_csv(
        {"vid0": [(f, "Fall" if f >= 40 else "Walk") for f in range(80)]})
    for j in range(13):
        annot[f"j{j}_x"] = rng.random(len(annot)) * 320
        annot[f"j{j}_y"] = rng.random(len(annot)) * 240
        annot[f"j{j}_s"] = 0.5 + 0.5 * rng.random(len(annot))
    annot_csv = str(tmp_path / "annot.csv")
    annot.to_csv(annot_csv, index=False)
    ours, theirs = _cli_both(lambda who: [
        "windows", "--annot", annot_csv, "--out", str(tmp_path / f"{who}.pkl")])
    _same_windows(ours, theirs)
    assert len(ours) == 50
    assert _bytes(tmp_path / "ours.pkl") == _bytes(tmp_path / "theirs.pkl")
