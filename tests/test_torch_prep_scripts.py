"""The port's preprocessing and analysis scripts
(``fourdgs_tpu_torch/scripts/<name>.py``) against the JAX package's
``scripts/<name>.py`` on the same tiny fixtures.

Each JAX script runs as a user runs it, in a subprocess; the port's runs in
this process through its ``main`` (one also as ``python -m``). Their
outputs must match: byte for byte where they write text, COLMAP binaries,
PLY, ``.npy`` or a database; the plots as decoded pixels; the oracle GT
frames of ``render_oracle_gt`` (64×64, 2 + 1 views, the port on the CPU)
within one uint8 level. Without matplotlib the plotting scripts exit with an
error that says so, before they write anything.
"""

import json
import os
import pathlib
import sqlite3
import subprocess
import sys

import numpy as np
import pytest

from fourdgs_tpu_torch.data import colmap_io
from fourdgs_tpu_torch.data.ply import store_pointcloud
from fourdgs_tpu_torch.scripts import (analyze_gradients, blender2colmap, colmap_converter,
                                       database, downsample_point, hypernerf2colmap,
                                       llff2colmap, llff_poses_from_colmap, plot_events,
                                       prepare_multipleview, preprocess_dynerf,
                                       read_all_metrics,
                                       render_oracle_gt, visualize_timing)
from fourdgs_tpu_torch.utils.png import read_png
from tests import h264_writer as HW
from tests.test_data import make_dnerf_dataset
from tests.test_torch_cli import one_torch_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def run_jax(name, *args, cwd=None):
    """``python scripts/<name>.py args`` as a user runs it; its stdout."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, str(ROOT / "scripts" / f"{name}.py"), *map(str, args)],
                         capture_output=True, text=True, cwd=cwd or ROOT, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout


def files_equal(a, b, names=None):
    """The files ``names`` (by default every file, the same in both) of the
    directories ``a`` and ``b`` are equal byte for byte."""
    a, b = pathlib.Path(a), pathlib.Path(b)
    if names is None:
        names = sorted(p.name for p in a.iterdir())
        assert names == sorted(p.name for p in b.iterdir())
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


def twin(tmp_path, make):
    """The fixture ``make(dir)`` made twice: one copy for each side."""
    dirs = []
    for side in ("jax", "port"):
        d = tmp_path / side
        d.mkdir()
        make(d)
        dirs.append(d)
    return dirs


def _rotation(rng):
    q = rng.normal(size=4)
    return colmap_io.qvec2rotmat(q / np.linalg.norm(q))


def _colmap_model(rng, n_img=4, n_pts=30):
    cams = {1: colmap_io.ColmapCamera(1, "PINHOLE", 64, 48, np.array([50.0, 51.0, 32.0, 24.0])),
            2: colmap_io.ColmapCamera(2, "SIMPLE_RADIAL", 80, 60,
                                      np.array([60.0, 40.0, 30.0, 0.01]))}
    imgs = {}
    for i in range(1, n_img + 1):
        q = rng.normal(size=4)
        k = int(rng.integers(2, 6))
        imgs[i] = colmap_io.ColmapImage(
            i, q / np.linalg.norm(q), rng.normal(size=3), 1 + i % 2, f"img{i:03d}.png",
            rng.uniform(0, 60, (k, 2)), rng.integers(-1, n_pts, k))
    pts = {}
    for j in range(1, n_pts + 1):
        t = int(rng.integers(1, 4))
        pts[j] = colmap_io.ColmapPoint3D(
            j, rng.normal(size=3) * 2 + [0, 0, 5], rng.integers(0, 256, 3).astype(np.uint8),
            float(rng.uniform(0, 2)), rng.integers(1, n_img + 1, t).astype(np.int32),
            rng.integers(0, 5, t).astype(np.int32))
    return cams, imgs, pts


def test_blender2colmap(tmp_path):
    jd, td = twin(tmp_path, lambda d: make_dnerf_dataset(d, n_train=3, n_test=1, size=32))
    run_jax("blender2colmap", jd)
    blender2colmap.main(str(td))
    files_equal(jd / "colmap" / "sparse_custom", td / "colmap" / "sparse_custom")
    files_equal(jd / "colmap" / "images", td / "colmap" / "images")
    assert "SIMPLE_PINHOLE 32 32" in (td / "colmap/sparse_custom/cameras.txt").read_text()


def test_colmap_converter_both_ways(tmp_path):
    rng = np.random.default_rng(0)
    colmap_io.write_model(*_colmap_model(rng), str(tmp_path / "bin"), ".bin")
    for src, fmt in (("bin", ".txt"), ("jax_txt", ".bin")):
        src_dir = tmp_path / src
        if src == "jax_txt":
            src_dir = tmp_path / "jax_out_.txt"
        run_jax("colmap_converter", "--input_model", src_dir, "--output_model",
                tmp_path / f"jax_out_{fmt}", "--output_format", fmt)
        colmap_converter.main(["--input_model", str(src_dir), "--output_model",
                               str(tmp_path / f"port_out_{fmt}"), "--output_format", fmt])
        files_equal(tmp_path / f"jax_out_{fmt}", tmp_path / f"port_out_{fmt}")
    files_equal(tmp_path / "bin", tmp_path / "port_out_.bin")   # a lossless round trip


def _hypernerf_fixture(d):
    rng = np.random.default_rng(1)
    ids = ["000001", "000002", "left_3"]
    (d / "camera").mkdir()
    (d / "rgb" / "2x").mkdir(parents=True)
    (d / "dataset.json").write_text(json.dumps({"ids": ids, "train_ids": ids[:2]}))
    for i in ids:
        (d / "camera" / f"{i}.json").write_text(json.dumps({
            "orientation": _rotation(rng).tolist(), "position": rng.normal(size=3).tolist(),
            "focal_length": 1234.5, "image_size": [536, 960],
            "principal_point": [268.0, 480.0]}))
        (d / "rgb" / "2x" / f"{i}.png").write_bytes(rng.bytes(50))


def test_hypernerf2colmap(tmp_path):
    jd, td = twin(tmp_path, _hypernerf_fixture)
    run_jax("hypernerf2colmap", jd)
    hypernerf2colmap.main(str(td))
    files_equal(jd / "colmap" / "sparse_custom", td / "colmap" / "sparse_custom")
    files_equal(jd / "colmap" / "images", td / "colmap" / "images")


def _llff_fixture(d):
    rng = np.random.default_rng(2)
    rows = []
    for i in range(3):
        pose = np.concatenate([_rotation(rng), rng.normal(size=(3, 1))], axis=1)
        hwf = np.array([[1014.0], [1352.0], [1400.0 + i]])
        rows.append(np.concatenate([np.concatenate([pose, hwf], 1).ravel(), [0.5, 9.0]]))
    np.save(d / "poses_bounds.npy", np.stack(rows))
    for i in (0, 2):          # camera 1 has no first frame: skipped, as in JAX
        (d / f"cam{i:02d}" / "images").mkdir(parents=True)
        (d / f"cam{i:02d}" / "images" / "0000.png").write_bytes(rng.bytes(40))


def test_llff2colmap(tmp_path):
    jd, td = twin(tmp_path, _llff_fixture)
    run_jax("llff2colmap", jd)
    llff2colmap.main(str(td))
    files_equal(jd / "colmap" / "sparse_custom", td / "colmap" / "sparse_custom")
    files_equal(jd / "colmap" / "images", td / "colmap" / "images")


@pytest.mark.parametrize("with_points", [True, False])
def test_llff_poses_from_colmap(tmp_path, with_points):
    def make(d):
        cams, imgs, pts = _colmap_model(np.random.default_rng(3))
        colmap_io.write_model(cams, imgs, pts if with_points else {}, str(d / "sparse_" / "0"),
                              ".bin")
        if not with_points:
            os.remove(d / "sparse_" / "0" / "points3D.bin")

    jd, td = twin(tmp_path, make)
    run_jax("llff_poses_from_colmap", jd)
    llff_poses_from_colmap.main(str(td))
    name = "poses_bounds_multipleview.npy"
    assert (jd / name).read_bytes() == (td / name).read_bytes()
    assert np.load(td / name).shape == (4, 17)


def _multipleview_fixture(d):
    rng = np.random.default_rng(4)
    for c in range(3):
        cam = d / f"cam{c:02d}"
        cam.mkdir()
        names = ["frame_00001.jpg", "frame_00002.jpg"] if c != 1 else ["a.jpg", "b.jpg"]
        for n in names:
            (cam / n).write_bytes(rng.bytes(30))
    (d / "cam03").mkdir()     # no frames: nothing staged for it


def test_prepare_multipleview(tmp_path):
    jd, td = twin(tmp_path, _multipleview_fixture)
    run_jax("prepare_multipleview", jd)
    subprocess.run([sys.executable, "-m", "fourdgs_tpu_torch.scripts.prepare_multipleview",
                    str(td)], cwd=ROOT, check=True, capture_output=True, timeout=120)
    files_equal(jd / "image_colmap", td / "image_colmap")
    assert len(list((td / "image_colmap").iterdir())) == 3


def _videos_fixture(d):
    for c in range(2):
        cfg = HW.Config(width=58, height=42, frames=3, seed=c)
        sps, pps, aus = HW.write(cfg)
        (d / f"cam{c:02d}.mp4").write_bytes(HW.mp4(sps, pps, aus, 58, 42))


def test_preprocess_dynerf(tmp_path, capsys):
    """The same frames (PNG pixels) for each camera, and the skip rule: a
    camera already holding ``--frames`` files is left alone."""
    jd, td = twin(tmp_path, _videos_fixture)
    args = ["--frames", "2", "--width", "32", "--height", "24"]
    run_jax("preprocess_dynerf", "--datadir", jd, *args)
    preprocess_dynerf.main(["--datadir", str(td), *args])
    for c in ("cam00", "cam01"):
        names = sorted(p.name for p in (td / c / "images").iterdir())
        assert names == sorted(p.name for p in (jd / c / "images").iterdir())
        assert names == ["0000.png", "0001.png"]
        for n in names:
            np.testing.assert_array_equal(read_png(str(td / c / "images" / n)),
                                          read_png(str(jd / c / "images" / n)))
    capsys.readouterr()
    preprocess_dynerf.main(["--datadir", str(td), *args])
    assert capsys.readouterr().out.count("already extracted") == 2


def test_downsample_point(tmp_path):
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(3000, 3)).astype(np.float32)
    store_pointcloud(str(tmp_path / "in.ply"), pts, rng.integers(0, 256, (3000, 3)))
    run_jax("downsample_point", tmp_path / "in.ply", tmp_path / "jax.ply", "--target", 500)
    downsample_point.main([str(tmp_path / "in.ply"), str(tmp_path / "port.ply"),
                           "--target", "500"])
    assert (tmp_path / "jax.ply").read_bytes() == (tmp_path / "port.ply").read_bytes()
    assert (tmp_path / "port.ply").stat().st_size < (tmp_path / "in.ply").stat().st_size


def _database_fixture(d):
    db = sqlite3.connect(d / "database.db")
    db.execute("CREATE TABLE cameras (camera_id INTEGER PRIMARY KEY, model INTEGER, "
               "width INTEGER, height INTEGER, params BLOB, prior_focal_length INTEGER)")
    for cid in (1, 2, 3):
        db.execute("INSERT INTO cameras VALUES (?, 2, 10, 10, ?, 0)",
                   (cid, np.zeros(4).tobytes()))
    db.commit()
    db.close()
    (d / "cameras.txt").write_text(
        "# Camera list\n1 SIMPLE_PINHOLE 1352 1014 1400.5 676 507\n\n"
        "2 PINHOLE 800 600 700 701 400 300\n3 OPENCV 64 48 50 51 32 24 0.1 -0.01 0 0\n")


def test_database(tmp_path):
    jd, td = twin(tmp_path, _database_fixture)
    run_jax("database", "--database_path", jd / "database.db", "--txt_path", jd / "cameras.txt")
    database.main(["--database_path", str(td / "database.db"),
                   "--txt_path", str(td / "cameras.txt")])
    rows = []
    for d in (jd, td):
        db = sqlite3.connect(d / "database.db")
        rows.append(db.execute("SELECT * FROM cameras ORDER BY camera_id").fetchall())
        db.close()
    assert rows[0] == rows[1]
    assert rows[1][0][1:4] == (0, 1352, 1014)
    assert np.frombuffer(rows[1][2][4]).tolist() == [50, 51, 32, 24, 0.1, -0.01, 0, 0]


def test_read_all_metrics(tmp_path, capsys):
    for run, psnr in (("dnerf/lego", 30.25), ("dnerf/jumpingjacks", 28.5)):
        (tmp_path / run).mkdir(parents=True)
        (tmp_path / run / "results.json").write_text(json.dumps(
            {"ours_14000": {"SSIM": 0.95, "PSNR": psnr, "LPIPS-vgg": None, "D-SSIM": 0.02}}))
    want = run_jax("read_all_metrics", tmp_path)
    read_all_metrics.main(str(tmp_path))
    assert capsys.readouterr().out == want
    assert "30.2500" in want


def _gradient_report(d, n=40):
    rng = np.random.default_rng(6)
    it = list(range(10, 10 * n + 1, 10))
    hist = {"xyz/norm": list(np.exp(-0.1 * np.arange(n)) * rng.uniform(0.5, 1.5, n)),
            "opacity/norm": list(rng.uniform(1e-3, 1e-2, n)),
            "deformation/norm": [1e-9] * n,
            "grid/norm": list(np.linspace(1, 500, n)),
            "xyz/mean": list(rng.normal(size=n))}
    (d / "gradient_report.json").write_text(json.dumps(
        {"iterations": it, "history": {k: [float(v) for v in vs] for k, vs in hist.items()}}))


def test_analyze_gradients(tmp_path, capsys):
    jd, td = twin(tmp_path, _gradient_report)
    out = run_jax("analyze_gradients", "--model_path", jd, "--plot")
    assert analyze_gradients.main(["--model_path", str(td), "--plot"]) == 0
    files_equal(jd, td, ["gradient_analysis.json", "gradient_report.json"])
    np.testing.assert_array_equal(read_png(str(td / "gradient_trends.png")),
                                  read_png(str(jd / "gradient_trends.png")))
    assert capsys.readouterr().out.replace(str(td), str(jd)).replace(
        "train_torch.py", "train.py") == out
    assert "VANISHING" in out and "EXPLODING" in out


def _events(d):
    rng = np.random.default_rng(7)
    lines = []
    for it in range(0, 200, 10):
        lines.append({"iter": it, "tag": "train/loss", "scalar": float(np.exp(-it / 80))})
        lines.append({"iter": it, "tag": "train/psnr", "scalar": float(20 + it / 20)})
        if it % 50 == 0:
            edges = np.linspace(-1, 1, 21)
            lines.append({"iter": it, "tag": "scene/opacity",
                          "hist": {"edges": edges.tolist(),
                                   "counts": rng.integers(0, 50, 20).tolist()}})
    (d / "events.jsonl").write_text("".join(json.dumps(x) + "\n" for x in lines))


def _timing_report(d):
    rng = np.random.default_rng(8)
    iters = []
    for i in range(1, 121):
        stage = "coarse" if i <= 40 else "fine"
        ph = {f"{stage}_render": float(rng.uniform(0.01, 0.02)),
              f"{stage}_data_loading": float(rng.uniform(1e-3, 2e-3))}
        if i == 60:
            ph[f"{stage}_render"] = 2.5        # a compile spike
        iters.append({"iteration": i, "stage": stage, "phases": ph,
                      "total_time": sum(ph.values())})
    ops = {"coarse_render": {"total_time": 0.6, "count": 40},
           "fine_render": {"total_time": 4.1, "count": 80},
           "densify": {"total_time": 0.3, "count": 3}}
    (d / "timing_report.json").write_text(json.dumps(
        {"summary": {"total_wall_time": 6.0, "unaccounted_time": 0.2, "operations": ops},
         "iterations": iters}))


@pytest.mark.parametrize("script", ["plot_events", "visualize_timing"])
def test_plotting_scripts(tmp_path, script):
    if script == "plot_events":
        jd, td = twin(tmp_path, _events)
        run_jax(script, "--model_path", jd)
        plot_events.main(["--model_path", str(td)])
        jd, td = jd / "plots", td / "plots"
    else:
        jd, td = twin(tmp_path, _timing_report)
        run_jax(script, jd / "timing_report.json")
        visualize_timing.main([str(td / "timing_report.json")])
        jd, td = jd / "timing_plots", td / "timing_plots"
        files_equal(jd, td, ["timing_analysis.txt"])
    names = sorted(p.name for p in jd.iterdir())
    assert names == sorted(p.name for p in td.iterdir()) and len(names) >= 2
    for n in names:
        if n.endswith(".png"):
            np.testing.assert_array_equal(read_png(str(td / n)), read_png(str(jd / n)), n)


@pytest.mark.parametrize("script", ["analyze_gradients", "plot_events", "visualize_timing"])
def test_plotting_scripts_say_matplotlib_is_missing(tmp_path, monkeypatch, script):
    """The card's host has no matplotlib: the scripts fail with an error
    that says so, before they write any plot."""
    _gradient_report(tmp_path)
    _events(tmp_path)
    _timing_report(tmp_path)
    monkeypatch.setitem(sys.modules, "matplotlib", None)   # import raises
    argv = {"analyze_gradients": ["--model_path", str(tmp_path), "--plot"],
            "plot_events": ["--model_path", str(tmp_path)],
            "visualize_timing": [str(tmp_path / "timing_report.json")]}[script]
    main = {"analyze_gradients": analyze_gradients.main, "plot_events": plot_events.main,
            "visualize_timing": visualize_timing.main}[script]
    with pytest.raises(SystemExit, match=f"{script}: matplotlib is not installed"):
        main(argv)
    assert not list(tmp_path.rglob("*.png"))


def test_render_oracle_gt(tmp_path):
    """64×64, 2 train + 1 test views: the JAX script (its oracle on the
    CPU) against the port's oracle on the CPU, within one uint8 level."""
    run_jax("render_oracle_gt", "--size", 64, "--n_train", 2, "--n_test", 1,
            "--out_dir", tmp_path / "jax")
    out = render_oracle_gt.main(["--size", "64", "--n_train", "2", "--n_test", "1",
                                 "--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    assert out == str(tmp_path / "port" / "oracle_gt_64_2_1.npz")
    with np.load(out) as got, np.load(tmp_path / "jax" / "oracle_gt_64_2_1.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got["train_meta"], want["train_meta"])
        np.testing.assert_array_equal(got["test_meta"], want["test_meta"])
        assert int(got["size"]) == 64
        for k in ("train_imgs", "test_imgs"):
            diff = np.abs(got[k].astype(int) - want[k].astype(int))
            assert diff.max() <= 1, k
            assert got[k].max() > 0      # the balls are in view
