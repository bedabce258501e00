"""The DyNeRF path's benches and chip checks on the CPU:

- ``bench_quality_dynerf_torch.py``'s config is the dynerf preset plus the
  overrides of ``bench_quality_dynerf.py:68-103``, field for field against
  the JAX config with those lines applied (at full and cut scales, with
  and without ``--instant4d``); its cameras, GT renders and init cloud are
  the JAX script's; a tiny CPU run prints one JSON line with every key of
  the JAX script's result and the port's counts;
- ``bench_quality_torch.py --instant4d`` trains an isotropic SH-0 model and
  says so in its line;
- ``interop`` round-trips a model at the dynerf preset's widths (K-planes
  [64, 64, 64, 150] × 16, ``net_width`` 128, ``defor_depth`` 0);
- ``chip_smoke.py``'s padding check (phase 11 (a)) and the ``reached``
  pairs its bounds charge the gates to (the kept pairs before a pixel
  freezes at T_STOP), against a serial walk of the kernels' loop.
"""

import ast
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

import bench_quality_dynerf_torch as BD
import bench_quality_torch as TB
import chip_smoke as CS
from fourdgs_tpu.configs.core import config_to_dict as jconfig_to_dict
from fourdgs_tpu.configs.core import load_config as jload_config
from fourdgs_tpu.models import gaussians as JG
from fourdgs_tpu_torch import interop
from fourdgs_tpu_torch.configs.core import KPlanesConfig, config_to_dict, load_config
from fourdgs_tpu_torch.models import gaussians as TG
from fourdgs_tpu_torch.ops import blend
from fourdgs_tpu_torch.utils import losses
from tests.test_torch_blend_backward import CASES, _torch_args
from tests.test_torch_cli import one_torch_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _jax_bench_config(scale, instant4d):
    """``bench_quality_dynerf.py:68-103`` applied to JAX's config of the
    preset, line for line."""
    cfg = jload_config(str(ROOT / "fourdgs_tpu/configs/presets/dynerf/default.py"))
    cfg.opt.coarse_iterations = max(int(3000 * scale), 50)
    cfg.opt.iterations = max(int(14000 * scale), 100)
    cfg.opt.densify_until_iter = min(cfg.opt.densify_until_iter, int(10000 * scale))
    cfg.opt.densify_from_iter = int(cfg.opt.densify_from_iter * scale)
    cfg.opt.pruning_from_iter = int(cfg.opt.pruning_from_iter * scale)
    cfg.opt.position_lr_max_steps = cfg.opt.iterations
    cfg.opt.opacity_reset_interval = max(int(3000 * scale), 100)
    cfg.opt.custom_sampler = "fine"
    cfg.tpu.backend = "pallas"
    cfg.tpu.payload_bf16 = True
    cfg.tpu.instance_budget = 256 * 1024
    cfg.tpu.instance_budget_max = 2 * 1024 * 1024
    cfg.hidden.zero_init_heads = True
    if instant4d:
        cfg.model.use_isotropic_gaussian = True
        cfg.model.sh_degree = 0
    return cfg


@pytest.mark.parametrize("scale,instant4d", [(1.0, False), (0.05, False), (0.02, True)])
def test_config_is_the_preset_plus_the_overrides(scale, instant4d):
    cfg = load_config(BD.PRESET)
    BD.configure(cfg, scale)
    if instant4d:
        TB.instant4d_config(cfg)
    got = json.loads(json.dumps(config_to_dict(cfg), default=str))
    want = json.loads(json.dumps(jconfig_to_dict(_jax_bench_config(scale, instant4d)),
                                 default=str))
    assert got == want
    assert (tuple(cfg.hidden.kplanes_config.resolution), cfg.hidden.net_width,
            cfg.hidden.defor_depth, cfg.opt.batch_size) == ((64, 64, 64, 150), 128, 0, 4)


def test_cameras_and_init_match_the_jax_script():
    """The ring's poses (``default_rng(7)``) and the init cloud
    (``default_rng(0)``), drawn in the JAX script's order."""
    rng = np.random.default_rng(7)
    assert BD.camera_poses() == [(rng.uniform(0, 2 * np.pi), rng.uniform(0.2, 0.8))
                                 for _ in range(BD.N_CAM)]
    pts_gt = TB.make_gt_scene()[0]
    rng = np.random.default_rng(0)
    surf = pts_gt[rng.choice(len(pts_gt), 4000)] + rng.normal(
        0, 0.05, (4000, 3)).astype(np.float32)
    want = np.concatenate([surf, rng.uniform(-1.1, 1.1, (4000, 3))]).astype(np.float32)
    got_pts, got_cols = BD.init_cloud(pts_gt)
    np.testing.assert_array_equal(got_pts, want)
    np.testing.assert_array_equal(got_cols, rng.uniform(0, 1, (8000, 3)).astype(np.float32))


def _jax_result_keys():
    """The keys of ``bench_quality_dynerf.py``'s ``result`` dict."""
    tree = ast.parse((ROOT / "bench_quality_dynerf.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "result" for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("no result dict in bench_quality_dynerf.py")


def _tiny(cfg):
    """A few steps per stage on a tiny deformation (CPU-sized)."""
    cfg.opt.coarse_iterations = cfg.opt.iterations = 1
    cfg.tpu.capacity_init = 16384
    cfg.hidden.kplanes_config = KPlanesConfig(resolution=(8, 8, 8, 4),
                                              output_coordinate_dim=8)
    cfg.hidden.multires = (1,)
    cfg.hidden.net_width = 16


def test_cpu_run_prints_every_key(monkeypatch, capsys, tmp_path):
    configure = BD.configure

    def short(cfg, scale):
        configure(cfg, scale)
        _tiny(cfg)

    monkeypatch.setattr(BD, "configure", short)
    monkeypatch.setattr(BD, "N_T", 2)          # 11 cameras × 2 timestamps
    out = tmp_path / "dynerf.json"
    BD.main(["--width", "40", "--height", "24", "--n_test_t", "1", "--instant4d",
             "--device", "cpu", "--log_interval", "1", "--out", str(out)])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert json.loads(out.read_text()) == res
    assert _jax_result_keys() <= set(res)
    port_keys = {"device", "payload", "sh_degree", "isotropic", "eval_views", "gt_launches",
                 "k1_launches", "k2_launches", "budget_growths", "final_instance_budget",
                 "capacity_growths", "final_capacity", "resets", "densify_events",
                 "growth_events", "first_train_psnr", "last_train_psnr", "train_log",
                 "stage_s", "test_psnrs_db"}
    assert port_keys <= set(res)
    assert res["backend"] == res["device"] == "cpu" and res["payload"] == "bf16"
    assert res["instant4d"] is True and res["isotropic"] is True and res["sh_degree"] == 0
    assert res["resolution"] == [40, 24] and res["cams_train"] == 11
    assert res["schedule"] == {"coarse": 1, "fine": 1} and res["batch_size"] == 4
    assert res["chip_minutes_vs_host_budget"] is None
    assert np.isfinite(res["test_psnr_db"]) and len(res["test_psnrs_db"]) == 1
    assert res["final_instance_budget"] == 512 * 1024     # the fine stage's fresh budget
    assert [e["stage"] for e in res["train_log"]] == ["coarse", "fine"]
    assert res["k1_launches"] == res["k2_launches"] == res["gt_launches"] == 0   # plain path


def test_bench_quality_instant4d(monkeypatch):
    def tiny(cfg):
        _tiny(cfg)
        cfg.tpu.capacity_init = 2048

    res, model = TB.run(size=32, n_train=2, n_test=1, device="cpu", adjust=tiny,
                        log_interval=100, instant4d=True)
    assert res["instant4d"] is True
    assert model.cfg.model.use_isotropic_gaussian and model.cfg.model.sh_degree == 0
    assert model.state.params["f_rest"].shape[1] == 0 and np.isfinite(res["test_psnr_db"])


def test_interop_round_trip_at_dynerf_widths():
    """A port model at the dynerf widths goes to JAX's parameter tree (the
    structure and shapes of JAX's ``create_from_pcd``, abstractly
    evaluated) and back, bit for bit."""
    jcfg = jload_config(str(ROOT / "fourdgs_tpu/configs/presets/dynerf/default.py"))
    tcfg = load_config(BD.PRESET)
    jcfg.tpu.capacity = tcfg.tpu.capacity = 1024
    pts = np.random.default_rng(0).uniform(-1, 1, (300, 3)).astype(np.float32)
    cols = np.full_like(pts, 0.5)
    want = jax.eval_shape(lambda: JG.create_from_pcd(jax.random.key(0), jcfg, pts, cols,
                                                     2.0)).params
    ts = TG.create_from_pcd(tcfg, pts, cols, 2.0, seed=0, device="cpu")
    deform = ts.params["deform"]
    assert deform.feature_out[0].weight.shape[0] == 128 and len(deform.feature_out) == 1
    params_np, alive, aabb = interop.to_numpy(ts)
    assert jax.tree.structure(params_np) == jax.tree.structure(want)
    assert jax.tree.map(np.shape, params_np) == jax.tree.map(lambda x: x.shape, want)
    back, alive2, aabb2 = interop.to_numpy(
        interop.from_jax_numpy(params_np, alive, aabb, tcfg, device="cpu"))
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(params_np)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(alive2, alive)
    np.testing.assert_array_equal(aabb2, aabb)
    grids = [x for k, x in params_np["deform"].items() if k.startswith("grid_")]
    assert len(grids) == 12 and all(g.shape[-1] == 16 for g in grids)
    assert {g.shape[1] for g in grids} == {64, 128, 150}


def _padded_step(h, w, seed=0):
    """A [T, 5, 256] render, its plain twin, a tiled GT and the step's L1
    cotangent at h × w, as ``chip_smoke.step_blend_inputs`` forms it."""
    rng = np.random.default_rng(seed)
    n = (-(-h // 16)) * (-(-w // 16))
    out5 = torch.tensor(rng.uniform(0, 1, (n, 5, 256)), dtype=torch.float32)
    gt = torch.tensor(rng.uniform(0, 1, (n, 5, 256)), dtype=torch.float32)
    mask = torch.tensor([1.0, 1.0, 1.0, 0.0, 0.0])[:, None] * losses.tile_pixel_mask(
        h, w, device="cpu")
    o = out5.clone().requires_grad_()
    (g_out,) = torch.autograd.grad(losses.abs_((o - gt) * mask).sum() / (4 * 3 * h * w), o)
    return out5, out5.clone(), g_out, gt


def test_padding_check():
    out5, plain5, g_out, gt = _padded_step(56, 72)
    res = CS.check_padding(out5, plain5, g_out, gt, 56, 72, torch.device("cpu"))
    assert res["padding_pixels"] == 20 * 256 - 56 * 72 and res["cotangent_zero"]
    assert res["loss_unchanged_by_noise"] and res["max_abs_err"] == 0.0
    with pytest.raises(AssertionError, match="loss reads the padding"):
        CS.check_padding(out5, plain5, torch.ones_like(g_out), gt, 56, 72,
                         torch.device("cpu"))
    with pytest.raises(AssertionError, match="disagrees"):
        CS.check_padding(out5, plain5 + 0.5, g_out, gt, 56, 72, torch.device("cpu"))
    with pytest.raises(AssertionError, match="no padding pixel"):
        CS.check_padding(*_padded_step(64, 64)[:3], _padded_step(64, 64)[3], 64, 64,
                         torch.device("cpu"))


def _reached_serial(feat, starts, stops, gx):
    """The kept pairs the kernels' walk reaches, walked as they walk it:
    per pixel, the tile's instances in order in float32, T multiplied
    directly, a pixel frozen at T_STOP until its chunk ends (the freezing
    pair counted)."""
    K = feat.shape[1]
    f = np.ascontiguousarray(feat, np.float32)
    sub = np.arange(256)
    n = 0
    for t, (s, e) in enumerate(zip(starts, stops)):
        px = ((t % gx) * 16 + sub % 16).astype(np.float32)
        py = ((t // gx) * 16 + sub // 16).astype(np.float32)
        T = np.ones(256, np.float32)
        frozen = np.zeros(256, bool)
        off0 = min(s // 8 * 8, K - 8)
        for i in range(s, e):
            if (i - off0) % 128 == 0:
                frozen[:] = False
            dx, dy = px - f[0, i], py - f[1, i]
            power = (np.float32(-0.5) * (f[2, i] * dx * dx + f[4, i] * dy * dy)
                     - f[3, i] * dx * dy)
            alpha = np.minimum(f[5, i] * np.exp(power), np.float32(0.99))
            keep = (power <= 0) & (alpha >= np.float32(1 / 255)) & ~frozen
            t_next = T * (np.float32(1) - alpha)
            live = keep & (t_next >= np.float32(1e-4))
            frozen |= keep & ~live
            T = np.where(live, t_next, T)
            n += int(keep.sum())
    return n


@pytest.mark.parametrize("case", sorted(CASES))
def test_reached_pairs_match_serial_walk(case):
    """Within 0.1% of the serial walk (a pixel riding T_STOP may freeze
    one instance apart, the association contract); kept ≥ reached ≥ live,
    and on saturated tiles most kept pairs lie past the freeze."""
    feat, starts, stops, gx, T, K = CASES[case]()
    f, s, e, r, _ = _torch_args(feat, starts, stops)
    got = blend.pair_counts(f, s, e, r, gx)
    want = _reached_serial(feat, starts, stops, gx)
    assert abs(got["reached_pairs"] - want) <= 1e-3 * want, (got, want)
    assert got["kept_pairs"] >= got["reached_pairs"] >= got["live_pairs"] > 0
    if case == "saturated":
        assert got["reached_pairs"] < 0.5 * got["kept_pairs"]
