"""D-SSIM in the train step (``opt.lambda_dssim != 0``) of the port against
the JAX package's.

- ``utils/losses.py::ssim_tiles`` on channel-major tile blocks within 1e-6
  of the float64 SSIM and of the port's image-space ``ssim``, and of JAX's
  (beyond JAX's own distance from the float64 value on close pairs), its
  gradient against ``jax.grad``'s to 1e-5 relative to the largest;
- ``make_train_step`` with ``lambda_dssim = 0.2``, step 1 from the same
  state against JAX's (the Pallas kernels under the interpreter) at
  ``tests/test_torch_train.py``'s tolerances: the metrics, the Adam moments
  (the gradients themselves) and the densification statistics, on an
  unpadded 64×64 grid (``ssim_tiles`` on the packed render) and a padded
  72×56 one (the image-space ``ssim``, as JAX keeps the images there); the
  D-SSIM term is live (loss − L1 above the regularizer alone);
- ``scene_reconstruction`` with D-SSIM on a padded grid keeps the GT cache
  untiled (JAX's rule, ``loop.py:492-493``) and trains.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_cfg, _tiny_scene
from fourdgs_tpu import render as JR
from fourdgs_tpu.models.gaussians import inverse_sigmoid
from fourdgs_tpu.train import adam as jadam
from fourdgs_tpu.train import loop as jloop
from fourdgs_tpu.utils import losses as jlosses
from fourdgs_tpu_torch import interop
from fourdgs_tpu_torch import render as TR
from fourdgs_tpu_torch.train import adam as tadam
from fourdgs_tpu_torch.train import loop as tloop
from fourdgs_tpu_torch.utils import losses as tlosses
from tests.test_torch_cli import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_math import warm_cpu_math  # noqa: F401  (autouse)
from tests.test_torch_train import _camera, _gt_forms, _leaves_close, _port_state, _t


@pytest.mark.parametrize("h,w,pair", [(64, 64, "independent"), (64, 64, "close"),
                                      (48, 80, "close")])
def test_ssim_tiles_matches_jax_and_image_ssim(h, w, pair):
    """Within 1e-6 of the float64 SSIM and of the port's image-space one.
    JAX's ``ssim_tiles`` (jitted, as its train step runs it) is itself up
    to ~3e-6 from the float64 value on close pairs, whose σ terms are small
    differences of the window sums; against it the bar is 1e-6 on top of
    JAX's own error."""
    rng = np.random.default_rng(h + w)
    a = rng.uniform(0, 1, (2, 3, h, w)).astype(np.float32)
    if pair == "close":
        b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    else:
        b = rng.uniform(0, 1, a.shape).astype(np.float32)
    ta = np.stack([np.asarray(jlosses.tile_image(jnp.asarray(x))) for x in a])
    tb = np.stack([np.asarray(jlosses.tile_image(jnp.asarray(x))) for x in b])
    gx, gy = w // 16, h // 16
    jax_ssim = jax.jit(lambda u, v: jlosses.ssim_tiles(u, v, gx, gy))
    want = float(jax_ssim(jnp.asarray(ta), jnp.asarray(tb)))
    exact = float(tlosses.ssim(_t(a).double(), _t(b).double()))
    x = _t(ta).requires_grad_()
    got = tlosses.ssim_tiles(x, _t(tb), gx, gy)
    (g,) = torch.autograd.grad(got, x)
    got = float(got.detach())
    assert abs(got - exact) <= 1e-6
    assert abs(got - float(tlosses.ssim(_t(a), _t(b)))) <= 1e-6
    assert abs(got - want) <= 1e-6 + abs(want - exact), (got, want, exact)
    if pair == "independent":
        assert abs(got - want) <= 1e-6
    jg = np.asarray(jax.grad(lambda v: jlosses.ssim_tiles(v, jnp.asarray(tb), gx, gy))(
        jnp.asarray(ta)))
    np.testing.assert_allclose(g.numpy(), jg, atol=1e-5 * float(np.abs(jg).max()))
    with pytest.raises(ValueError):
        tlosses.ssim_tiles(x, _t(tb), gx + 1, gy)


# (stage, batch, white background, H, W, GT form)
CASES = {
    "fine-64-uint8": ("fine", 1, True, 64, 64, "uint8_hwc"),
    "fine-padded-72x56-float": ("fine", 1, False, 56, 72, "float_chw"),
}


@functools.cache
def _both_step1(case):
    stage, B, white, h, w, form = CASES[case]
    cfg = _tiny_cfg()
    assert cfg.opt.lambda_dssim == 0.2
    cfg.model.white_background = white
    jstate = _tiny_scene(cfg, seed=3)
    params = dict(jstate.params)
    # opacities ×0.1: transmittance clear of T_STOP (test_torch_render.py)
    params["opacity"] = inverse_sigmoid(0.1 * jax.nn.sigmoid(params["opacity"]))
    jstate = jstate._replace(params=params)
    cams = [_camera(i, w, h, time=0.2 + 0.5 * i) for i in range(B)]
    jcams = jax.tree.map(lambda *xs: jnp.stack(xs),
                         *[JR.CameraArrays.from_camera(c) for c in cams])
    tcams = TR.CameraArrays(*(_t(np.asarray(x)) for x in jcams))
    img = np.random.default_rng(12).uniform(0, 1, (B, 3, h, w)).astype(np.float32)
    gts = _gt_forms(img, form)
    jstep = jloop.make_train_step(cfg, w, h, stage, active_sh_degree=1)
    j1 = jstep(jstate.params, jadam.init(jstate.params), jstate, jcams, jnp.asarray(gts), 1)
    tstep = tloop.make_train_step(cfg, w, h, stage, 1, device="cpu")
    tstate = _port_state(jstate, cfg)
    t1 = tstep(tstate.params, tadam.init(tstate.params), tstate, tcams, _t(gts), 1)
    # the same step without the D-SSIM term (from a fresh copy: the step
    # updates the parameters in place): the term's share of the loss
    cfg.opt.lambda_dssim = 0.0
    tstate = _port_state(jstate, cfg)
    t0 = tloop.make_train_step(cfg, w, h, stage, 1, device="cpu")(
        tstate.params, tadam.init(tstate.params), tstate, tcams, _t(gts), 1)
    return j1, t1, t0


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_step_with_dssim_matches_jax(case):
    (jp1, ja1, js1, jm1), (tp1, ta1, ts1, tm1), (_, _, _, tm0) = _both_step1(case)
    for k in ("num_rendered", "max_tile_len", "n_points"):
        assert int(tm1[k]) == int(jm1[k]), k
    for k in ("loss", "l1", "psnr"):
        np.testing.assert_allclose(float(tm1[k]), float(jm1[k]), rtol=1e-5, err_msg=k)
    # the term is live: λ·(1 − SSIM) of random GT is far above the float noise
    assert float(tm1["loss"]) - float(tm0["loss"]) > 0.1
    np.testing.assert_allclose(float(tm1["l1"]), float(tm0["l1"]), rtol=1e-6)
    mu, nu, count = interop.adam_to_numpy(ta1)
    assert count == int(ja1.count) == 1
    _leaves_close(mu, ja1.mu, 4e-3, 2e-3, "mu")
    _leaves_close(nu, ja1.nu, 8e-3, 4e-3, "nu")
    for k in ("max_radii2d", "denom"):
        np.testing.assert_array_equal(getattr(ts1, k).numpy(),
                                      np.asarray(getattr(js1, k)), err_msg=k)
    np.testing.assert_allclose(ts1.xyz_gradient_accum.numpy(),
                               np.asarray(js1.xyz_gradient_accum), rtol=4e-3,
                               atol=2e-3 * float(np.abs(js1.xyz_gradient_accum).max()))


def test_scene_reconstruction_dssim_on_padded_grid(monkeypatch):
    """JAX's GT-cache rule: with D-SSIM on a padded grid the cached GT stays
    [N, H, W, C] (the step reads images), not pre-tiled; two steps train."""
    from fourdgs_tpu_torch.models import gaussians as TG
    from tests.test_torch_loop import _port_cfg

    cfg = _port_cfg()
    cfg.tpu.capacity = 256
    cfg.opt.lambda_dssim = 0.2
    h, w = 56, 72
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.8, 0.8, (128, 3)).astype(np.float32)
    state = TG.create_from_pcd(cfg, pts, rng.uniform(0, 1, (128, 3)), 1.0, device="cpu")
    cams = [(_camera(i, w, h, time=0.0),
             rng.integers(0, 256, (h, w, 3), dtype=np.uint8)) for i in range(2)]
    seen = []
    make = tloop.make_train_step

    def spy(*a, **kw):
        step = make(*a, **kw)

        def wrapped(params, adam_state, st, batch_cams, gts, it):
            seen.append(tuple(gts.shape))
            return step(params, adam_state, st, batch_cams, gts, it)
        return wrapped

    monkeypatch.setattr(tloop, "make_train_step", spy)
    _, _, log = tloop.scene_reconstruction(cfg, state, tadam.init(state.params), cams,
                                           "coarse", 2, 1.0, device="cpu")
    assert seen and all(s[1:] == (h, w, 3) for s in seen), seen
    assert np.isfinite(log.iterations[-1]["loss"])
    assert log.iterations[-1]["loss"] > log.iterations[-1]["l1"]
