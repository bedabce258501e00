"""The ``tile`` and ``reference`` backends of the port against the JAX
package's.

- ``ops/binning.py::bin_gaussians`` (the lexicographic binning) equal to
  JAX's in every integer output, also when the demand exceeds the budget;
- ``rasterize_reference`` and ``rasterize_tiled``, forward and the gradients
  of every Gaussian input and the means2d carrier, against JAX's to 1e-5
  (the gradients relative to each one's largest magnitude), on a scene
  clear of T_STOP and on a saturated one;
- ``render(backend=...)`` with ``tile_space`` on and off against JAX's
  ``render`` of the same backend, and the tile-space block equal to the
  image tiled; an unknown backend raises ``ValueError``; no backend is
  chosen but the one the config or the caller names;
- ``train_torch.py --override`` takes ``tpu.ellipse_tile_cull``,
  ``opt.lambda_dssim`` and ``tpu.backend``, which raised before.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _camera, _tiny_cfg, _tiny_scene
from fourdgs_tpu import render as JR
from fourdgs_tpu.ops.binning import bin_gaussians as jbin
from fourdgs_tpu.ops.preprocess import preprocess as jpreprocess
from fourdgs_tpu.ops.reference import rasterize_reference as jref
from fourdgs_tpu.ops.tiled import rasterize_tiled as jtiled
from fourdgs_tpu_torch import interop
from fourdgs_tpu_torch import render as TR
from fourdgs_tpu_torch.ops.binning import bin_gaussians as tbin
from fourdgs_tpu_torch.ops.reference import rasterize_reference as tref
from fourdgs_tpu_torch.ops.tiled import rasterize_tiled as ttiled
from fourdgs_tpu_torch.utils.losses import tile_image
from tests.test_math_core import look_at_camera
from tests.test_tiled_raster import random_scene
from tests.test_torch_cli import frames_64, one_torch_thread  # noqa: F401  (fixtures)
from tests.test_torch_math import warm_cpu_math  # noqa: F401  (autouse)

BG = np.array([0.15, 0.25, 0.35], np.float32)
KEYS = ("means3d", "scales", "rotations", "opacities", "shs")


def _t(x):
    return torch.from_numpy(np.array(x))


def _scene(kind):
    cam = look_at_camera([0.3, -0.2, -4], [0, 0, 0], width=48, height=40)
    p = {k: np.array(v) for k, v in random_scene(64, seed=3, spread=0.8).items()}
    if kind == "clear":     # transmittance clear of T_STOP
        p["opacities"] = (0.1 * p["opacities"]).astype(np.float32)
    else:                   # opaque splats: pixels reach T_STOP
        p["opacities"] = np.full((64,), 0.95, np.float32)
        p["means3d"] = (0.4 * p["means3d"]).astype(np.float32)
    return p, cam


@pytest.mark.parametrize("kind", ["fits", "overflows"])
def test_bin_gaussians_matches_jax(kind):
    p, cam = _scene("clear")
    pre = jpreprocess(*(jnp.asarray(p[k]) for k in ("means3d", "scales", "rotations", "shs")),
                      jnp.array(cam.camera_center), jnp.array(cam.world_view),
                      jnp.array(cam.full_proj), cam.tanfovx, cam.tanfovy, 48, 40, 3)
    demand = int(pre.tiles_touched.sum())
    K = 2048 if kind == "fits" else demand // 2
    j = jbin(pre.tile_min, pre.tile_max, pre.tiles_touched, pre.depths, 3, 3, K)
    t = tbin(*(_t(x) for x in (pre.tile_min, pre.tile_max, pre.tiles_touched,
                               pre.depths)), 3, 3, K)
    assert int(t.num_rendered) == int(j.num_rendered) == demand
    for name in ("gauss_id", "tile_id", "tile_start", "tile_stop"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), err_msg=name)
    np.testing.assert_array_equal((t.tile_id < 9).numpy(), np.asarray(j.valid))


def _port_grads(fn, p, cam, **kw):
    leaves = {k: _t(p[k]).requires_grad_() for k in KEYS}
    carrier = torch.zeros((len(p["means3d"]), 2), requires_grad=True)
    out = fn(*(leaves[k] for k in KEYS), _t(cam.camera_center), _t(cam.world_view),
             _t(cam.full_proj), cam.tanfovx, cam.tanfovy, cam.width, cam.height, 3,
             _t(BG), means2d_offset=carrier, **kw)
    w = torch.from_numpy(np.random.default_rng(2).uniform(
        -1, 1, tuple(out.color.shape)).astype(np.float32))
    loss = (out.color * w).sum() + 0.1 * out.depth.sum() + out.alpha.sum()
    grads = torch.autograd.grad(loss, [leaves[k] for k in KEYS] + [carrier])
    return out, [g.numpy() for g in grads]


def _jax_grads(fn, p, cam, **kw):
    w = np.random.default_rng(2).uniform(-1, 1, (3, cam.height, cam.width)).astype(np.float32)

    def loss(*args):
        *leaves, carrier = args
        out = fn(*leaves, jnp.array(cam.camera_center), jnp.array(cam.world_view),
                 jnp.array(cam.full_proj), cam.tanfovx, cam.tanfovy, cam.width,
                 cam.height, 3, jnp.asarray(BG), means2d_offset=carrier, **kw)
        return (jnp.sum(out.color * w) + 0.1 * jnp.sum(out.depth) + jnp.sum(out.alpha),
                out)

    args = [jnp.asarray(p[k]) for k in KEYS] + [jnp.zeros((len(p["means3d"]), 2))]
    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=tuple(range(6)),
                                                 has_aux=True))(*args)
    return out, [np.asarray(g) for g in grads]


@pytest.mark.parametrize("backend", ["reference", "tile"])
@pytest.mark.parametrize("kind", ["clear", "saturated"])
def test_rasterizer_and_gradients_match_jax(backend, kind):
    p, cam = _scene(kind)
    if backend == "reference":
        kw = dict(chunk=32)
        t, tg = _port_grads(tref, p, cam, **kw)
        j, jg = _jax_grads(jref, p, cam, **kw)
    else:
        kw = dict(instance_budget=2048, tile_budget=128, chunk=32)
        t, tg = _port_grads(ttiled, p, cam, **kw)
        j, jg = _jax_grads(jtiled, p, cam, **kw)
        assert int(t.num_rendered) == int(j.num_rendered)
        assert int(t.max_tile_len) == int(j.max_tile_len) <= 128
    for name in ("color", "depth", "alpha"):
        np.testing.assert_allclose(getattr(t, name).detach().numpy(),
                                   np.asarray(getattr(j, name)), atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(t.radii.numpy(), np.asarray(j.radii))
    if kind == "saturated":
        assert float(t.alpha.detach().max()) > 0.99   # some pixel reached T_STOP
    for name, g, w in zip(KEYS + ("means2d_offset",), tg, jg):
        scale = float(np.abs(w).max())
        assert scale > 0, name
        np.testing.assert_allclose(g, w, atol=1e-5 * scale, err_msg=name)


@pytest.fixture(scope="module")
def tiny():
    cfg = _tiny_cfg()
    state = _tiny_scene(cfg)
    params = dict(state.params)
    params["opacity"] = params["opacity"] - 2.0   # clear of T_STOP
    state = state._replace(params=params)
    tstate = interop.from_jax_numpy(jax.tree.map(np.asarray, state.params),
                                    np.asarray(state.alive), np.asarray(state.aabb),
                                    cfg, device="cpu")
    return cfg, state, tstate


@pytest.mark.parametrize("backend", ["reference", "tile"])
def test_render_backends_match_jax(tiny, backend):
    cfg, state, tstate = tiny
    cfg.tpu.tile_budget = 256       # the longest tile (250 instances) fits
    jcam = JR.CameraArrays.from_camera(_camera(size=64))
    tcam = TR.CameraArrays.from_camera(_camera(size=64), device="cpu")
    j = jax.jit(lambda prm: JR.render(prm, state, jcam, cfg, 64, 64, "fine",
                                      jnp.asarray(BG), 1, backend=backend))(state.params)
    with torch.no_grad():
        t = TR.render(tstate.params, tstate, tcam, cfg, 64, 64, "fine", _t(BG), 1,
                      device="cpu", backend=backend)
        ts = TR.render(tstate.params, tstate, tcam, cfg, 64, 64, "fine", _t(BG), 1,
                       device="cpu", backend=backend, tile_space=True)
    np.testing.assert_allclose(t.color.numpy(), np.asarray(j.color), atol=1e-5)
    np.testing.assert_allclose(t.depth.numpy(), np.asarray(j.depth), atol=2e-5)
    np.testing.assert_allclose(t.alpha.numpy(), np.asarray(j.alpha), atol=1e-5)
    assert int(t.num_rendered) == int(j.num_rendered)
    assert int(t.max_tile_len) == int(j.max_tile_len) <= cfg.tpu.tile_budget
    # the packed (r, g, b, depth, t_fin) block of the pallas backend
    assert tuple(ts.color.shape) == (16, 5, 256)
    np.testing.assert_array_equal(ts.color[:, 0:3].numpy(), tile_image(t.color).numpy())
    np.testing.assert_array_equal(ts.color[:, 3:4].numpy(), tile_image(t.depth).numpy())
    np.testing.assert_array_equal(ts.color[:, 4:5].numpy(),
                                  (1.0 - tile_image(t.alpha)).numpy())
    # and against the pallas backend (its plain blend here), the same image
    with torch.no_grad():
        pal = TR.render(tstate.params, tstate, tcam, cfg, 64, 64, "fine", _t(BG), 1,
                        device="cpu")
    np.testing.assert_allclose(t.color.numpy(), pal.color.numpy(), atol=1e-5)


def test_backend_is_what_config_or_caller_names(tiny):
    cfg, _, tstate = tiny
    tcam = TR.CameraArrays.from_camera(_camera(size=64), device="cpu")
    with pytest.raises(ValueError, match="unknown backend 'cuda'"):
        TR.render(tstate.params, tstate, tcam, cfg, 64, 64, "fine", _t(BG), 1,
                  device="cpu", backend="cuda")
    cfg.tpu.backend = "reference"
    try:
        with torch.no_grad():
            out = TR.render(tstate.params, tstate, tcam, cfg, 64, 64, "coarse", _t(BG),
                            1, device="cpu")
    finally:
        cfg.tpu.backend = "pallas"
    assert int(out.num_rendered) == 0 == int(out.max_tile_len)   # JAX's zeros


@pytest.mark.parametrize("overrides", [
    ("opt.lambda_dssim=0.2", "tpu.ellipse_tile_cull=true"),
    ('tpu.backend="reference"', "opt.lambda_dssim=0.2"),
    ('tpu.backend="tile"',),
])
def test_train_cli_takes_the_options(tmp_path, frames_64, overrides):
    """``train_torch.py --override`` with the options that raised before
    (``tpu.ellipse_tile_cull``, ``opt.lambda_dssim``, ``tpu.backend``):
    the run trains, saves its model, and logs finite losses."""
    import train_torch
    from tests.test_data import make_dnerf_dataset
    from tests.test_torch_cli import OVERRIDES

    data_dir = tmp_path / "data"
    make_dnerf_dataset(data_dir, n_train=3, n_test=1, size=64)
    model_path = tmp_path / "model"
    base = [o for o in OVERRIDES if not o.startswith(("opt.iterations", "opt.coarse",
                                                      "tpu.backend"))]
    train_torch.main(["-s", str(data_dir), "--model_path", str(model_path), "--quiet",
                      "--device", "cpu", "--test_iterations", "3", "--save_iterations", "3",
                      "--override", *base, "opt.coarse_iterations=2", "opt.iterations=3",
                      *overrides])
    assert (model_path / "point_cloud" / "iteration_3").is_dir()


def test_chip_smoke_options_phase_on_cpu(monkeypatch, tmp_path):
    """``chip_smoke.py`` phase 14 on the CPU at 64×64 (1,500 Gaussians, a
    32k budget, 1 + 3 steps) with the plain versions; the oracle frames it
    checks are the port's own at 64×64, since the committed ones are
    800×800."""
    import chip_smoke as CS
    from fourdgs_tpu_torch import scripts
    from fourdgs_tpu_torch.configs import core
    from fourdgs_tpu_torch.ops import blend
    from fourdgs_tpu_torch.scripts import render_oracle_gt

    for name, value in (("WIDTH", 64), ("HEIGHT", 64), ("N_POINTS", 1500),
                        ("CAPACITY", 2048), ("N_TIMED", 3), ("N_WARM", 1)):
        monkeypatch.setattr(CS, name, value)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    for name, value in (("ITERS", 1), ("REPS", 1), ("WARMUP", 1)):
        monkeypatch.setattr(scripts, name, value)
    # K2's batch is read from its built library on the card
    monkeypatch.setattr(blend, "k2_reduction",
                        lambda: {"batch": 3, "shuffles": 31, "unbatched": 50})
    load = core.load_config

    def small_budget(path=None):
        cfg = load(path)
        cfg.tpu.instance_budget = 32768
        return cfg

    monkeypatch.setattr(core, "load_config", small_budget)
    render_oracle_gt.main(["--size", "64", "--n_train", "2", "--n_test", "1",
                           "--out_dir", str(tmp_path), "--device", "cpu"])
    np_load = np.load
    monkeypatch.setattr(np, "load", lambda p, *a, **k: np_load(
        tmp_path / "oracle_gt_64_2_1.npz" if "oracle_gt_800" in str(p) else p, *a, **k))
    dev = torch.device("cpu")
    cfg = small_budget(CS.LEGO)
    cfg.tpu.capacity = CS.CAPACITY
    with torch.no_grad():
        state = CS.bench_scene(cfg, device=dev)
        cam = TR.CameraArrays.from_camera(CS.ring_camera(1, 3), device=dev)
        gt = tile_image(TR.render(state.params, state, cam, cfg, 64, 64, "fine", torch.ones(3),
                                  3, device=dev).color, pad_cols=2)[None]
        res = CS.check_options(cfg, state, cam, gt, 100.0, dev)
    a, b, c = res["a"], res["b"], res["c"]
    assert a["on"]["num_rendered"] < a["off"]["num_rendered"]
    assert a["on"]["launches"] == a["off"]["launches"] == 0     # the plain path
    assert a["image"]["over_1e-6_not_riding"] == 0
    assert b["loss"][1] < b["loss"][0] and b["dssim_term_last"] > 0
    assert abs(b["ssim"]["tiles_minus_f64"]) <= 1e-5
    assert c["tile"]["over_1e-2"] == 0 and c["reference"]["max_level_diff"] == 0
