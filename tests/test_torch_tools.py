"""The port's tools against the JAX package's, on the CPU, and
``chip_smoke.py`` phase 13 at a narrow width.

- ``export_perframe_3DGS_torch.py``: one PLY per test camera, each equal to
  JAX's ``export_perframe_3DGS.get_state_at_time`` within 1e-5 on the same
  snapshot (written by the port, read by JAX's ``checkpoint.load_snapshot``),
  the opacity undeformed as in the reference.
- ``merge_many_4dgs_torch.py``: ``rotate_point_cloud`` equal to JAX's; the
  merged frames of a model twice over (rotated, moved, scaled) against
  JAX's ``merge_many_4dgs.py``, which renders with ``rasterize_tiled``: within
  one level of 255, except pixels riding T_STOP (their transmittance below
  1e-3 in the port's render), where the association contract of
  ``tests/test_pallas_raster.py:14-21`` lets one instance flip; at most 1% of
  the pixels may be such. Both sides run on two video cameras (the loaders
  are wrapped to keep the first two).
- ``full_eval_torch.py``'s command lines against JAX's ``full_eval.py``,
  ``subprocess.run`` captured on both sides: equal up to the ``_torch``
  script names, the scripts' and presets' absolute paths (the port's run
  from any directory) and ``--device``.
- ``chip_smoke.py`` phase 13 (:func:`chip_smoke.check_eval_tools`) at 64×64
  with a narrow model, its ``full_eval`` commands run in this process.
"""

import os
import subprocess

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke as CS
import export_perframe_3DGS as JEX
import export_perframe_3DGS_torch as TEX
import full_eval
import full_eval_torch
import merge_many_4dgs as JMG
import merge_many_4dgs_torch as TMG
import metrics_torch
import render_torch
import train_torch
from fourdgs_tpu.configs.core import config_from_dict
from fourdgs_tpu.data import blender as jblender
from fourdgs_tpu.data import scene as jscene
from fourdgs_tpu.train import checkpoint as jckpt
from fourdgs_tpu_torch.data import ply as tply
from fourdgs_tpu_torch.data import scene as tscene
from fourdgs_tpu_torch.ops.rasterize import rasterize_pallas
from fourdgs_tpu_torch.render import CameraArrays
from fourdgs_tpu_torch.utils import png
from tests.test_data import make_dnerf_dataset
from tests.test_torch_cli import OVERRIDES, frames_64, one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def trained(tmp_path_factory, frames_64):
    """(scene dir, model path, JAX's config and state of its snapshot)."""
    import json

    data_dir = tmp_path_factory.mktemp("dnerf_data")
    make_dnerf_dataset(data_dir, n_train=4, n_test=2, size=64)
    model_path = str(tmp_path_factory.mktemp("out") / "model")
    train_torch.main(["-s", str(data_dir), "--model_path", model_path, "--quiet",
                      "--test_iterations", "-1", "--save_iterations", "6",
                      "--device", "cpu", "--override", *OVERRIDES])
    with open(os.path.join(model_path, "cfg_args.json")) as f:
        jcfg = config_from_dict(json.load(f))
    jstate = jckpt.load_snapshot(os.path.join(model_path, "point_cloud", "iteration_6"),
                                 jcfg, jax.random.key(0))
    return str(data_dir), model_path, jcfg, jstate


def test_export_matches_jax(trained):
    data_dir, model_path, jcfg, jstate = trained
    paths = TEX.main(["--model_path", model_path, "--device", "cpu"])
    times = [lc.camera.time for lc in tscene.load_scene(jcfg, data_dir).test_cameras]
    assert len(paths) == len(times) == 2
    assert [os.path.basename(p) for p in paths] == ["time_00000.ply", "time_00001.ply"]
    alive = np.asarray(jstate.alive)
    for path, t in zip(paths, times):
        got = tply.load_gaussian_ply(path)
        xyz, scales, rot, opacity, shs = JEX.get_state_at_time(jstate.params, jstate, jcfg, t)
        n = shs.shape[0]
        want = {"xyz": xyz, "scaling": scales, "rotation": rot, "opacity": opacity,
                "f_dc": shs[:, 0, :], "f_rest": shs[:, 1:, :].reshape(n, -1)}
        for k, v in want.items():
            np.testing.assert_allclose(got[k], np.asarray(v)[alive], rtol=0, atol=1e-5,
                                       err_msg=f"{os.path.basename(path)} {k}")
        # the reference's undeformed opacity
        np.testing.assert_array_equal(got["opacity"],
                                      np.asarray(jstate.params["opacity"])[alive])


def test_rotate_point_cloud_matches_jax():
    xyz = np.random.default_rng(0).normal(size=(100, 3)).astype(np.float32)
    for motion, rot, scale in (((0.5, 0, 0), ("90", "0"), 0.8),
                               ((0.1, -0.2, 0.3), ("30", "-45"), 1.3)):
        got = TMG.rotate_point_cloud(torch.from_numpy(xyz), motion, rot, scale).numpy()
        want = np.asarray(JMG.rotate_point_cloud(xyz, motion, rot, scale))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


MERGE_ARGS = ["--rotation_bias", "90,0", "--motion_bias", "0.5,0,0", "--scale_bias", "0.8"]


def test_merge_matches_jax(trained, tmp_path, monkeypatch):
    data_dir, model_path, jcfg, _ = trained
    t_load, j_load = tscene.load_scene, jscene.load_scene

    def port_scene(cfg, path=None):
        data = t_load(cfg, path)
        return data._replace(video_cameras=data.video_cameras[:2])

    def jax_scene(cfg, path=None):    # JAX's loader at the port's test frame size
        data = jblender.load_blender_scene(path or cfg.model.source_path,
                                           white_background=cfg.model.white_background,
                                           target_size=(64, 64))
        return data._replace(video_cameras=data.video_cameras[:2])

    monkeypatch.setattr(tscene, "load_scene", port_scene)
    monkeypatch.setattr(jscene, "load_scene", jax_scene)
    args = ["--model_paths", model_path, model_path, "-s", data_dir, *MERGE_ARGS]
    res = TMG.main([*args, "--output", str(tmp_path / "port"), "--device", "cpu"])
    JMG.main([*args, "--output", str(tmp_path / "jax")])
    assert res["frames"] == 2
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) \
        == ["00000.png", "00001.png"]

    models = [TMG.load_model(model_path, -1, None, "cpu")] * 2
    cfg = models[0][0]
    bg = torch.ones(3) if cfg.model.white_background else torch.zeros(3)
    for i, cam in enumerate(port_scene(cfg, data_dir).video_cameras):
        got = png.read_png(str(tmp_path / "port" / f"{i:05d}.png")).astype(int)
        want = np.asarray(Image.open(tmp_path / "jax" / f"{i:05d}.png")).astype(int)
        assert got.shape == want.shape == (64, 64, 3)
        xyz, sc, rot, op, shs, deg = TMG.merged_gaussians(
            models, cam.time, [(0.5, 0.0, 0.0)], [("90", "0")], [0.8])
        ca = CameraArrays.from_camera(cam, device="cpu")
        with torch.no_grad():
            out = rasterize_pallas(xyz, sc, rot, op, shs, ca.camera_center, ca.world_view,
                                   ca.full_proj, ca.tanfovx, ca.tanfovy, 64, 64, deg, bg,
                                   instance_budget=TMG.INSTANCE_BUDGET)
        saturated = (1.0 - out.alpha[0].numpy()) < 1e-3
        off = np.abs(got - want).max(axis=2) > 1
        assert not (off & ~saturated).any(), np.argwhere(off & ~saturated)[:5]
        assert off.mean() <= 0.01
        assert (got != want).mean() < 0.05


@pytest.mark.parametrize("family,extra", [
    ("dnerf", ["--scenes", "bouncingballs", "lego"]), ("hypernerf", []),
    ("dynerf", ["--scenes", "flame_steak", "--skip_train"]),
    ("dnerf", ["--scenes", "trex", "--skip_render", "--skip_metrics"])])
def test_full_eval_command_lines_match_jax(family, extra, monkeypatch):
    monkeypatch.chdir(ROOT)      # JAX's presets and scripts are relative to it
    calls = []
    monkeypatch.setattr(subprocess, "run", lambda cmd, **kw: calls.append((list(cmd), kw)))
    argv = ["--base_dir", "/data/sets", "--family", family, *extra]
    full_eval.main(argv)
    want = calls[:]
    calls.clear()
    full_eval_torch.main([*argv, "--device", "cuda"])
    got = calls[:]
    assert len(got) == len(want) > 0
    for (g, gkw), (w, wkw) in zip(got, want):
        assert gkw == wkw == {"check": True}
        assert g[-2:] == ["--device", "cuda"] and g[0] == w[0]
        assert os.path.dirname(g[1]) == ROOT
        assert os.path.basename(g[1]) == w[1].replace(".py", "_torch.py")
        rest = [os.path.relpath(a, ROOT) if a.startswith(ROOT + os.sep) else a
                for a in g[2:-2]]
        assert rest == w[2:]
    assert full_eval_torch.FAMILIES == full_eval.FAMILIES


def test_chip_smoke_eval_tools_phase_on_cpu(tmp_path, monkeypatch):
    """Phase 13 on the CPU: phase 10 (b)'s scene writer at 64×64, the
    narrow model of ``tests/test_torch_cli.py`` with 10 + 10 steps (a
    gradient record at coarse 10 and fine 10), the capture-size scene at
    128×96 for a 64×48 loader, the merge at a 2^16-instance budget (the
    plain blend's arrays follow the budget), ``full_eval``'s commands run in
    this process (where the frame sizes are set). Every check of the phase
    holds; the launch counts are 0 (the plain path)."""
    monkeypatch.setattr(tscene, "DYNERF_SIZE", (64, 48))
    monkeypatch.setattr(TMG, "INSTANCE_BUDGET", 1 << 16)
    dev = torch.device("cpu")
    data_dir = str(tmp_path / "bouncingballs")
    CS.write_dnerf_scene(data_dir, dev, size=64, n_train=4, n_test=2)
    schedule = [o for o in OVERRIDES if not o.startswith("opt.")] + [
        "opt.coarse_iterations=10", "opt.iterations=10", "opt.position_lr_max_steps=10"]
    mains = {"render_torch.py": render_torch.main, "metrics_torch.py": metrics_torch.main}

    def in_process(cmd, check=True):
        mains[os.path.basename(cmd[1])](cmd[2:])

    out = CS.check_eval_tools(dev, data_dir, schedule, lpips_size=64, capture=(128, 96),
                              run_script=in_process)
    assert out["a"]["launches"] == out["c"]["launches"] == (0, 0)
    assert out["a"]["records"] == 2 and out["a"]["steps"] == 20
    assert all(out["a"]["plots"].values())
    assert out["b"]["plys"] == 2 and out["b"]["max_abs_err"] <= 1e-6
    assert out["c"]["frames"] == 160 and out["c"]["max_level_diff"] <= 1
    assert np.isfinite(out["d"]["psnr"])
    assert all(v["diff"] <= 1e-5 for v in out["e"]["nets"].values())
    assert out["e"]["pretrained"] == {"vgg": False, "alex": False}
    assert out["f"]["fixtures"] == 90 and out["f"]["worst"] == 0 and out["f"]["frames"] == 6
