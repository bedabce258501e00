"""The port's gradient tracker (``utils/gradient_tracker.py``) and
``make_train_step(track_grads=True)`` against the JAX package's.

- ``compute_grad_stats`` of the port's step-1 gradients against JAX's
  ``compute_grad_stats`` of JAX's step-1 gradients on
  ``__graft_entry__._tiny_cfg`` (``tests/test_torch_train.py``'s batch-2
  case, whose cached JAX step this file shares). JAX's gradients are read
  from its first Adam moment (``mu = 0.1·g``), as that file reads them, and
  held to its tolerance: rtol 4e-3 and 2e-3 of the group's largest
  |gradient|.
- The report's JSON equals JAX's byte for byte on the same records, and
  ``scripts/analyze_gradients.py`` reads the port's report.
- ``gradient_timeline``'s records equal JAX's on the same state (JAX's
  interpreted Pallas render and its autodiff against the port's render and
  autograd): the losses and the |∇xyz| norms within rtol 1e-5 (measured:
  2e-7).
- The plots: with matplotlib the PNGs are written; without it each plot
  prints one line naming its PNG and returns None, and the JSON files are
  written all the same.
- ``train_torch.py --gradient_tracking --device cpu`` writes the report, the
  curves and the timeline, with a record every 10 iterations.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train_torch
from __graft_entry__ import _camera, _tiny_cfg, _tiny_scene
from fourdgs_tpu.utils import gradient_tracker as JGT
from fourdgs_tpu_torch import interop
from fourdgs_tpu_torch.train import adam as tadam
from fourdgs_tpu_torch.train import loop as tloop
from fourdgs_tpu_torch.utils import gradient_tracker as TGT
from tests.test_data import make_dnerf_dataset
from tests.test_torch_cli import OVERRIDES, one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_train import _jax_step1, _port_state, _t

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASE = "fine-b2-white-float"
STATS = ("mean", "std", "min", "max", "norm")


@pytest.fixture(scope="module")
def step_stats():
    """(port stats as floats, JAX stats as floats, the group scales: the
    largest |gradient| of each JAX group) of step 1 of :data:`CASE`."""
    (cfg, stage, w, h, jstate, _, tcams, gts), _, (_, ja1, _, _) = _jax_step1(CASE)
    jgrads = jax.tree.map(lambda m: jnp.asarray(m) / jnp.float32(0.1), ja1.mu)
    want = jax.tree.map(float, JGT.compute_grad_stats(jgrads))
    tstate = _port_state(jstate, cfg)
    tstep = tloop.make_train_step(cfg, w, h, stage, 1, device="cpu", track_grads=True)
    _, _, _, m = tstep(tstate.params, tadam.init(tstate.params), tstate, tcams, _t(gts), 1)
    P = tstate.alive.shape[0]
    assert m["vs_grad_norm"].shape == (P,) and bool(torch.isfinite(m["vs_grad_norm"]).all())
    got = {g: {k: float(v) for k, v in s.items()} for g, s in m["grad_stats"].items()}
    scale = {g: max(abs(s["min"]), abs(s["max"])) for g, s in want.items()}
    return got, want, scale


def test_grad_stats_match_jax(step_stats):
    got, want, scale = step_stats
    assert sorted(got) == sorted(want) == sorted(TGT.GROUPS)   # sh 1: f_rest present
    for group in want:
        assert sorted(got[group]) == sorted(STATS)
        for stat in STATS:
            np.testing.assert_allclose(got[group][stat], want[group][stat], rtol=4e-3,
                                       atol=2e-3 * scale[group] + 1e-30,
                                       err_msg=f"{group}/{stat}")


def test_grad_stats_split_by_grid_in_key():
    """The deform leaves split by name: ``grids.*`` is the grid group, and
    an empty ``f_rest`` (SH degree 0) has no group."""
    g = {"xyz": torch.ones(3, 3), "f_dc": torch.ones(3, 3), "f_rest": torch.zeros(3, 0),
         "opacity": torch.ones(3, 1), "scaling": torch.ones(3, 3),
         "rotation": torch.ones(3, 4),
         "deform": {"grids.grid_s0_p0": torch.full((2, 2), 3.0),
                    "feature_out.0.weight": torch.full((2,), -1.0),
                    "heads.pos.1.bias": torch.full((2,), 1.0)}}
    stats = TGT.compute_grad_stats(g)
    assert "f_rest" not in stats
    assert float(stats["grid"]["norm"]) == 6.0 and float(stats["grid"]["std"]) == 0.0
    assert float(stats["deformation"]["mean"]) == 0.0
    assert float(stats["deformation"]["std"]) == 1.0


def make_records():
    """Ten records of seeded statistics, two stages, one group vanishing and
    one exploding."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(1, 11):
        stats = {g: {k: float(rng.normal()) for k in STATS} for g in TGT.GROUPS}
        stats["f_rest"]["norm"] = 1e-9
        stats["grid"]["norm"] = 1e3
        out.append((10 * i, "coarse" if i <= 4 else "fine", stats))
    return out


def test_report_is_jax_byte_for_byte(tmp_path):
    trackers = {"port": TGT.GradientTracker(str(tmp_path / "port")),
                "jax": JGT.GradientTracker(str(tmp_path / "jax"))}
    for tracker in trackers.values():
        for rec in make_records():
            tracker.record(*rec)
    got = trackers["port"].generate_report()
    want = trackers["jax"].generate_report()
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()
    with open(got) as f:
        report = json.load(f)
    assert sorted(report) == ["anomalies", "history", "iterations", "stages", "summary"]
    assert report["anomalies"] == {"vanishing": ["f_rest"], "exploding": ["grid"]}
    disabled = TGT.GradientTracker(str(tmp_path), enable=False)
    disabled.record(*make_records()[0])
    assert disabled.iterations == [] and not disabled.history


def test_analyze_gradients_reads_the_ports_report(tmp_path):
    tracker = TGT.GradientTracker(str(tmp_path))
    for rec in make_records():
        tracker.record(*rec)
    tracker.generate_report()
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "analyze_gradients.py"),
                           "--model_path", str(tmp_path)], capture_output=True, text=True,
                          check=True, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    with open(tmp_path / "gradient_analysis.json") as f:
        result = json.load(f)
    assert sorted(result["groups"]) == sorted(TGT.GROUPS)
    assert result["vanishing"] == ["f_rest"] and result["exploding"] == ["grid"]
    assert result["iterations_analyzed"] == 10 and "EXPLODING" in proc.stdout


@pytest.fixture(scope="module")
def timeline_state():
    cfg = _tiny_cfg()
    cfg.opt.lambda_dssim = 0.0
    jstate = _tiny_scene(cfg, seed=3)
    gt = np.random.default_rng(7).uniform(0, 1, (3, 64, 64)).astype(np.float32)
    return cfg, jstate, _camera(), gt


def test_timeline_matches_jax(timeline_state, tmp_path):
    cfg, jstate, cam, gt = timeline_state
    JGT.gradient_timeline(cfg, jstate, cam, gt, str(tmp_path / "jax"))
    tstate = interop.from_jax_numpy(jax.tree.map(np.asarray, jstate.params),
                                    np.asarray(jstate.alive), np.asarray(jstate.aabb),
                                    cfg, device="cpu")
    paths = TGT.gradient_timeline(cfg, tstate, cam, gt, str(tmp_path / "port"), device="cpu")
    assert all(os.path.exists(p) for p in paths)
    with open(tmp_path / "jax" / "gradient_timeline.json") as f:
        want = json.load(f)
    with open(paths[0]) as f:
        got = json.load(f)
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert g["t"] == w["t"] and g["n_points"] == w["n_points"] == 256
        for k in ("loss", "grad_norm_mean", "grad_norm_max"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)


def test_plots_with_and_without_matplotlib(timeline_state, tmp_path, monkeypatch, capsys):
    """Both branches of the lazy import: the PNGs with matplotlib; without
    it one line per plot naming its PNG, None, and the JSON files still
    written."""
    cfg, jstate, cam, gt = timeline_state
    tstate = interop.from_jax_numpy(jax.tree.map(np.asarray, jstate.params),
                                    np.asarray(jstate.alive), np.asarray(jstate.aabb),
                                    cfg, device="cpu")
    os.makedirs(tmp_path / "with")
    tracker = TGT.GradientTracker(str(tmp_path / "with"))
    for rec in make_records():
        tracker.record(*rec)
    xyz = np.random.default_rng(1).normal(size=(50, 3))
    assert os.path.exists(tracker.visualize_gradient_curves())
    assert os.path.exists(tracker.visualize_gradient_3d(xyz, np.abs(xyz[:, 0]), 10, "fine"))

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    tracker.model_path = str(tmp_path / "without")
    os.makedirs(tracker.model_path)
    capsys.readouterr()
    assert tracker.visualize_gradient_curves() is None
    assert tracker.visualize_gradient_3d(xyz, np.abs(xyz[:, 0]), 10, "fine") is None
    json_path, png_path = TGT.gradient_timeline(
        cfg, tstate, cam, gt, tracker.model_path, time_points=[0.0, 0.5], device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert png_path is None and os.path.exists(json_path)
    assert len(out) == 3 and all("matplotlib is not installed" in line for line in out)
    assert [os.path.basename(line.split(": ")[1].split()[0]) for line in out] == [
        "gradient_curves.png", "gradient_3d_fine_10.png", "gradient_timeline.png"]
    assert not any(f.endswith(".png") for f in os.listdir(tracker.model_path))


def test_train_cli_writes_the_report(tmp_path, monkeypatch):
    """``train_torch.py --gradient_tracking`` over 10 coarse + 10 fine steps:
    a record at coarse 10 and fine 10 for every group the config trains,
    finite, then the curves and the 10-point timeline."""
    from fourdgs_tpu_torch.data import scene as tscene

    monkeypatch.setattr(tscene, "TARGET_SIZE", (64, 64))
    make_dnerf_dataset(tmp_path / "data", n_train=4, n_test=1, size=64)
    model = str(tmp_path / "model")
    overrides = [o for o in OVERRIDES if not o.startswith(("opt.iterations",
                                                           "opt.coarse_iterations"))]
    train_torch.main(["-s", str(tmp_path / "data"), "--model_path", model, "--quiet",
                      "--gradient_tracking", "--test_iterations", "-1",
                      "--save_iterations", "-1", "--device", "cpu", "--override",
                      "opt.iterations=10", "opt.coarse_iterations=10", *overrides])
    with open(os.path.join(model, "gradient_report.json")) as f:
        report = json.load(f)
    assert report["iterations"] == [10, 10] and report["stages"] == ["coarse", "fine"]
    groups = {k.split("/")[0] for k in report["history"]}
    assert groups == set(TGT.GROUPS)
    assert all(len(v) == 2 and all(np.isfinite(v)) for v in report["history"].values())
    assert os.path.exists(os.path.join(model, "gradient_curves.png"))
    with open(os.path.join(model, "gradient_timeline.json")) as f:
        timeline = json.load(f)
    assert len(timeline) == 10 and all(np.isfinite(r["loss"]) for r in timeline)
    assert os.path.exists(os.path.join(model, "gradient_timeline.png"))
