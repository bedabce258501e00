"""The port's last entry points against the JAX package's:

- ``python -m fourdgs_tpu_torch.scripts.gradient_from_checkpoint`` on a
  port checkpoint (its config restored from ``cfg_args.json``) against
  JAX's ``gradient_timeline`` on the same state, which JAX reads from the
  port's snapshot of it (snapshots load across packages): the records
  within rtol 1e-5, as ``tests/test_torch_gradient_tracker.py`` holds the
  timeline.
- The capture drivers with a stub ``colmap`` on ``PATH`` (it logs each
  command line and, as ``feature_extractor`` would, creates the database's
  camera table): ``convert_torch.py``, ``colmap_torch.sh`` and
  ``multipleviewprogress_torch.sh`` give JAX's drivers' COLMAP command
  lines and the same files; ``fourdgs_tpu_torch/scripts/run_instant4d.sh``
  and ``debug_test.sh``, under a stub ``python`` that logs the scripts it is
  given, call ``train_torch.py``, ``render_torch.py`` and
  ``metrics_torch.py`` with JAX's drivers' arguments, on presets that
  exist. No COLMAP binary is assumed.
- ``verify_improvements_torch.py --device cpu`` prints JAX's
  ``verify_improvements.py`` lines (the pruned count and the SH-0 widths
  among them) but the time, and returns its figures.
"""

import json
import os
import pathlib
import sqlite3
import subprocess
import sys

import jax
import numpy as np
import pytest

import verify_improvements_torch
from __graft_entry__ import _tiny_cfg, _tiny_scene
from fourdgs_tpu.configs.core import config_to_dict
from fourdgs_tpu.train import checkpoint as jcheckpoint
from fourdgs_tpu.utils import gradient_tracker as JGT
from fourdgs_tpu_torch import interop
from fourdgs_tpu_torch.configs.core import config_from_dict
from fourdgs_tpu_torch.data import colmap_io
from fourdgs_tpu_torch.data import scene as tscene
from fourdgs_tpu_torch.scripts import gradient_from_checkpoint
from fourdgs_tpu_torch.train import adam as tadam
from fourdgs_tpu_torch.train import checkpoint as tcheckpoint
from tests.test_data import make_dnerf_dataset
from tests.test_torch_cli import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_prep_scripts import (_colmap_model, _multipleview_fixture, files_equal,
                                           twin)

ROOT = pathlib.Path(__file__).resolve().parent.parent
TIMES = [0.0, 1.0]


def test_gradient_from_checkpoint_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(tscene, "TARGET_SIZE", (64, 64))
    data = tmp_path / "data"
    make_dnerf_dataset(data, n_train=3, n_test=1, size=64)
    cfg = _tiny_cfg()
    cfg.opt.lambda_dssim = 0.0
    jstate0 = _tiny_scene(cfg, seed=3)
    tstate = interop.from_jax_numpy(jax.tree.map(np.asarray, jstate0.params),
                                    np.asarray(jstate0.alive), np.asarray(jstate0.aabb),
                                    cfg, device="cpu")
    model = tmp_path / "model"
    model.mkdir()
    (model / "cfg_args.json").write_text(json.dumps(config_to_dict(cfg), default=str))
    ckpt = tcheckpoint.save_checkpoint(str(model), tstate, tadam.init(tstate.params), 10,
                                       "fine")
    json_path, _ = gradient_from_checkpoint.main([
        "--checkpoint", ckpt, "-s", str(data), "--n_times", str(len(TIMES)),
        "--camera", "1", "--device", "cpu"])
    assert json_path == str(model / "grad_from_ckpt" / "gradient_timeline.json")
    with open(json_path) as f:
        got = json.load(f)

    snap = tcheckpoint.save_snapshot(str(model), tstate, 10)
    jstate = jcheckpoint.load_snapshot(snap, cfg, jax.random.key(0))
    tcfg = config_from_dict(config_to_dict(cfg))
    lc = tscene.load_scene(tcfg, str(data)).train_cameras[1]
    gt = np.asarray(lc.image).astype(np.float32).transpose(2, 0, 1) / 255.0
    JGT.gradient_timeline(cfg, jstate, lc.camera, gt, str(tmp_path / "jax"),
                          time_points=TIMES)
    with open(tmp_path / "jax" / "gradient_timeline.json") as f:
        want = json.load(f)
    assert len(got) == len(want) == len(TIMES)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert g["t"] == w["t"] and g["n_points"] == w["n_points"] == 256
        for k in ("loss", "grad_norm_mean", "grad_norm_max"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)


# -- the capture drivers -----------------------------------------------------

STUB_COLMAP = """#!{python}
import json, os, sqlite3, sys
with open(os.environ["STUB_LOG"], "a") as f:
    f.write(json.dumps(["colmap", *sys.argv[1:]]) + "\\n")
if sys.argv[1] == "feature_extractor":      # COLMAP creates the database
    db = sys.argv[sys.argv.index("--database_path") + 1]
    con = sqlite3.connect(db)
    con.execute("CREATE TABLE IF NOT EXISTS cameras (camera_id INTEGER PRIMARY KEY, "
                "model INTEGER, width INTEGER, height INTEGER, params BLOB, "
                "prior_focal_length INTEGER)")
    for cid in (1, 2):
        con.execute("INSERT OR REPLACE INTO cameras VALUES (?, 2, 10, 10, ?, 0)",
                    (cid, bytes(32)))
    con.commit()
    con.close()
"""

# a `python` that logs the script it is given and runs stdin (`python -`)
STUB_PYTHON = """#!{python}
import json, os, sys
if sys.argv[1:2] == ["-"]:
    os.execv({python!r}, [{python!r}, "-"])
with open(os.environ["STUB_LOG"], "a") as f:
    f.write(json.dumps(["python", *sys.argv[1:]]) + "\\n")
"""


def stub_env(tmp_path, name, stubs):
    """PATH with a directory of the stubs first, and the log they append to."""
    bin_dir = tmp_path / f"bin_{name}"
    bin_dir.mkdir()
    for tool, body in stubs.items():
        path = bin_dir / tool
        path.write_text(body.format(python=sys.executable))
        path.chmod(0o755)
    log = tmp_path / f"{name}.log"
    env = dict(os.environ, STUB_LOG=str(log), JAX_PLATFORMS="cpu",
               PATH=f"{bin_dir}{os.pathsep}{pathlib.Path(sys.executable).parent}"
                    f"{os.pathsep}{os.environ['PATH']}",
               PYTHONPATH=str(ROOT))
    return env, log


def run_driver(cmd, tmp_path, name, workdir, stubs=None, cwd=ROOT):
    """Run a driver with the stubs on PATH; its logged command lines with
    ``workdir`` written ``<W>``."""
    env, log = stub_env(tmp_path, name, stubs or {"colmap": STUB_COLMAP})
    res = subprocess.run([str(c) for c in cmd], cwd=cwd, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = log.read_text().splitlines() if log.exists() else []
    return [[a.replace(str(workdir), "<W>") for a in json.loads(line)] for line in lines]


def db_rows(path):
    con = sqlite3.connect(path)
    try:
        return con.execute("SELECT * FROM cameras ORDER BY camera_id").fetchall()
    finally:
        con.close()


@pytest.mark.parametrize("flags", [[], ["--skip_matching", "--no_gpu"]],
                         ids=["full", "skip_matching"])
def test_convert_gives_jax_command_lines(tmp_path, flags):
    jd, td = twin(tmp_path, lambda d: (d / "input").mkdir())
    want = run_driver([sys.executable, "convert.py", "-s", jd, *flags], tmp_path, "jax", jd)
    got = run_driver([sys.executable, "convert_torch.py", "-s", td, *flags], tmp_path,
                     "port", td)
    assert got == want and [c[1] for c in got][-1] == "image_undistorter"
    assert (td / "sparse" / "0").is_dir()


def test_colmap_sh_gives_jax_command_lines_and_files(tmp_path):
    jd, td = twin(tmp_path, lambda d: make_dnerf_dataset(d, n_train=3, n_test=1, size=32))
    want = run_driver(["bash", "colmap.sh", jd, "blender"], tmp_path, "jax", jd)
    got = run_driver(["bash", "colmap_torch.sh", td, "blender"], tmp_path, "port", td)
    assert got == want
    assert [c[1] for c in got] == ["feature_extractor", "exhaustive_matcher",
                                   "point_triangulator", "image_undistorter",
                                   "patch_match_stereo", "stereo_fusion"]
    files_equal(jd / "colmap" / "sparse_custom", td / "colmap" / "sparse_custom")
    files_equal(jd / "colmap" / "images", td / "colmap" / "images")
    assert db_rows(td / "colmap" / "database.db") == db_rows(jd / "colmap" / "database.db")


def test_multipleviewprogress_sh_gives_jax_command_lines_and_files(tmp_path):
    def fixture(d):
        _multipleview_fixture(d)
        # what the mapper would have written: a sparse model of the rig
        colmap_io.write_model(*_colmap_model(np.random.default_rng(3)),
                              str(d / "sparse_" / "0"))

    jd, td = twin(tmp_path, fixture)
    want = run_driver(["bash", "multipleviewprogress.sh", jd], tmp_path, "jax", jd)
    got = run_driver(["bash", "multipleviewprogress_torch.sh", td], tmp_path, "port", td)
    assert got == want and len(got) == 4
    files_equal(jd / "image_colmap", td / "image_colmap")
    np.testing.assert_array_equal(np.load(td / "poses_bounds_multipleview.npy"),
                                  np.load(jd / "poses_bounds_multipleview.npy"))


@pytest.mark.parametrize("script,n_python", [("run_instant4d.sh", 15), ("debug_test.sh", 5)])
def test_ablation_drivers_call_the_ports_entry_points(tmp_path, script, n_python):
    # `column` (util-linux) formats debug_test.sh's summary; a stand-in here
    stubs = {"python": STUB_PYTHON, "column": "#!/bin/sh\ncat \"$2\"\n"}
    out = tmp_path / "out"
    want = run_driver(["bash", ROOT / "scripts" / script, "/data/scene", out], tmp_path,
                      "jax", out, stubs, cwd=tmp_path)
    got = run_driver(["bash", ROOT / "fourdgs_tpu_torch" / "scripts" / script,
                      "/data/scene", out], tmp_path, "port", out, stubs, cwd=tmp_path)
    assert len(got) == len(want) == n_python
    ported = {"train.py": "train_torch.py", "render.py": "render_torch.py",
              "metrics.py": "metrics_torch.py"}
    assert got == [[c[0], ported[c[1]], *c[2:]] for c in want]
    for cmd in got:
        if "--configs" in cmd:
            assert (ROOT / cmd[cmd.index("--configs") + 1]).is_file()


def test_verify_improvements_prints_jax_figures(tmp_path, capsys):
    res = verify_improvements_torch.main(["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    want = subprocess.run([sys.executable, str(ROOT / "verify_improvements.py")],
                          capture_output=True, text=True, cwd=ROOT, env=env,
                          timeout=300, check=True).stdout.splitlines()
    assert got[:-1] == want[:-1]
    assert got[-1].startswith("all checks passed in ")
    assert f"{res['points']} → {res['pruned']} points" in got[1]
    assert res["points"] == 50_000 and 0 < res["pruned"] < 50_000
    assert res["f_rest_width"] == 0
