"""The pre-slot ellipse-vs-tile cull (``tpu.ellipse_tile_cull``) of the port
against the JAX package's.

- ``_select_bit`` on every rank of random 32-bit masks, and the SWAR
  popcount, against JAX's and a NumPy walk of the bits;
- the cull's integer outputs (mask, big, ``tiles_touched``) and the whole
  binning with it (``gauss_id``, ``tile_id``, the tile ranges,
  ``num_rendered`` and the segment bookkeeping) equal to JAX's on the same
  preprocess outputs: the stretched, dim ellipses of
  ``tests/test_pallas_raster.py:178-200``, rects of more than 32 cells, and a
  nonzero tile-row offset and stride. A cell may differ only where
  ``|½·λ·d² − c|`` lies within 4 ulps of ``c``: counted (0 on these seeds);
- the port's preprocess gives JAX's ``lam_min`` and ``cull_c``;
- the render with the cull equals the render without it to 1e-6, apart from
  pixels that may ride T_STOP (final T below 1e-2, counted), and so do the
  per-Gaussian payload gradients; it also equals JAX's
  ``rasterize_pallas(..., ellipse_tile_cull=True, interpret=True)`` and the
  JAX ``render`` with ``cfg.tpu.ellipse_tile_cull`` at the render parity
  tests' tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _camera, _tiny_cfg, _tiny_scene
from fourdgs_tpu import render as JR
from fourdgs_tpu.ops import binning as jbinning
from fourdgs_tpu.ops.preprocess import preprocess as jpreprocess
from fourdgs_tpu.ops.rasterize import rasterize_pallas as jrasterize
from fourdgs_tpu_torch import interop
from fourdgs_tpu_torch import render as TR
from fourdgs_tpu_torch.ops import binning as tbinning
from fourdgs_tpu_torch.ops.preprocess import preprocess as tpreprocess
from fourdgs_tpu_torch.ops.rasterize import rasterize_pallas as trasterize
from tests.test_math_core import look_at_camera
from tests.test_tiled_raster import random_scene
from tests.test_torch_cli import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_math import warm_cpu_math  # noqa: F401  (autouse)

BG = (0.15, 0.25, 0.35)


def _t(x):
    return torch.from_numpy(np.array(x))


def _scene(case):
    """(scene dict of numpy arrays, camera, tile_row_offset, stride)."""
    if case == "stretched":       # tests/test_pallas_raster.py:178-200
        cam = look_at_camera([0.2, -0.3, -4], [0, 0, 0], width=64, height=64)
        p = {k: np.array(v) for k, v in random_scene(96, seed=9, spread=0.5).items()}
        p["scales"][:, 0] *= 6.0
        p["opacities"] = np.full((96,), 0.02, np.float32)
        return p, cam, 0, 1
    if case == "big_rects":       # rects of more than 32 cells
        cam = look_at_camera([0.1, -0.2, -3], [0, 0, 0], width=128, height=128)
        p = {k: np.array(v) for k, v in random_scene(64, seed=4, spread=0.6).items()}
        p["scales"] = p["scales"] * np.where(np.arange(64) % 4 == 0, 4.0, 1.0)[:, None].astype(
            np.float32)
        p["opacities"] = np.full((64,), 0.05, np.float32)
        return p, cam, 0, 1
    # a shard's interleaved slab: tile rows 1, 3, 5, ... of the full grid
    cam = look_at_camera([0.3, -0.1, -4], [0, 0, 0], width=64, height=64)
    p = {k: np.array(v) for k, v in random_scene(96, seed=7, spread=0.6).items()}
    p["scales"][:, 0] *= 6.0
    p["opacities"] = np.full((96,), 0.02, np.float32)
    return p, cam, 1, 2


def _jax_pre(p, cam):
    return jpreprocess(
        jnp.asarray(p["means3d"]), jnp.asarray(p["scales"]), jnp.asarray(p["rotations"]),
        jnp.asarray(p["shs"]), jnp.array(cam.camera_center), jnp.array(cam.world_view),
        jnp.array(cam.full_proj), cam.tanfovx, cam.tanfovy, cam.width, cam.height, 3,
        opacities=jnp.asarray(p["opacities"]))


def _slab(pre, offset, stride, grid_y):
    """JAX's clip of the rects to a shard's rows (``rasterize.py:290-322``),
    in local row coordinates."""
    rows = -(-(grid_y - offset) // stride)
    tmin, tmax = np.array(pre.tile_min), np.array(pre.tile_max)
    tmin[:, 1] = np.clip((tmin[:, 1] - offset + stride - 1) // stride, 0, rows)
    tmax[:, 1] = np.clip((tmax[:, 1] - offset + stride - 1) // stride, 0, rows)
    tt = np.where(tmax[:, 1] > tmin[:, 1], (tmax[:, 0] - tmin[:, 0])
                  * (tmax[:, 1] - tmin[:, 1]), 0).astype(np.int32)
    return tmin, tmax, tt, rows


def _near_threshold(pre, tmin, tmax, tt, offset, stride):
    """[P, 32] bool: cells whose ½·λ·d² lies within 4 ulps of c (float64 from
    the float32 inputs), where a rounding may decide the test either way."""
    w = np.maximum(tmax[:, 0] - tmin[:, 0], 1)[:, None].astype(np.int64)
    j = np.arange(32)[None, :]
    jy = j // w
    tx = tmin[:, :1] + (j - jy * w)
    ty = tmin[:, 1:2] + jy
    m = np.asarray(pre.means2d, np.float64)
    px0 = tx * 16.0 - 1.0
    py0 = (ty * stride + offset) * 16.0 - 1.0
    dx = m[:, :1] - np.clip(m[:, :1], px0, px0 + 17.0)
    dy = m[:, 1:] - np.clip(m[:, 1:], py0, py0 + 17.0)
    q = 0.5 * np.asarray(pre.lam_min, np.float64)[:, None] * (dx * dx + dy * dy)
    c = np.asarray(pre.cull_c, np.float64)[:, None]
    ulp = np.spacing(np.abs(c).astype(np.float32)).astype(np.float64)
    return (np.abs(q - c) <= 4 * ulp) & (j < tt[:, None])


def test_select_bit_and_popcount_match_jax_on_every_rank():
    rng = np.random.default_rng(0)
    masks = np.concatenate([rng.integers(0, 1 << 32, 200, dtype=np.uint64),
                            [0, 1, 1 << 31, (1 << 32) - 1, 0x55555555, 0xAAAAAAAA]])
    masks = masks.astype(np.uint32)
    pc = tbinning.popcount32(torch.from_numpy(masks.astype(np.int64))).numpy()
    np.testing.assert_array_equal(pc, [bin(int(m)).count("1") for m in masks])
    m = np.repeat(masks, 32)
    r = np.tile(np.arange(32, dtype=np.int32), len(masks))
    got = tbinning._select_bit(torch.from_numpy(m.astype(np.int64)),
                               torch.from_numpy(r.astype(np.int64))).numpy()
    want = np.asarray(jbinning._select_bit(jnp.asarray(m), jnp.asarray(r)))
    np.testing.assert_array_equal(got, want)       # every rank, undefined ones too
    for mask, rank, pos in zip(m, r, got):         # the defined ones by their bits
        bits = [i for i in range(32) if int(mask) >> i & 1]
        if rank < len(bits):
            assert pos == bits[rank]


@pytest.mark.parametrize("case", ["stretched", "big_rects", "row_slab"])
def test_cull_and_binning_match_jax(case):
    p, cam, offset, stride = _scene(case)
    pre = _jax_pre(p, cam)
    gx, gy = -(-cam.width // 16), -(-cam.height // 16)
    tmin, tmax, tt = (np.asarray(x) for x in (pre.tile_min, pre.tile_max, pre.tiles_touched))
    if stride > 1:
        tmin, tmax, tt, gy = _slab(pre, offset, stride, gy)
    cull = (pre.means2d, pre.lam_min, pre.cull_c)
    jm, jb, jt = jbinning._rect_cull_mask(jnp.asarray(tmin), jnp.asarray(tmax),
                                          jnp.asarray(tt), *cull, offset, stride)
    tm, tb, ttt = tbinning._rect_cull_mask(_t(tmin), _t(tmax), _t(tt),
                                           *(_t(x) for x in cull), offset, stride)
    jm = np.asarray(jm).astype(np.int64)
    bits = np.arange(32)
    differ = ((jm[:, None] >> bits) & 1) != ((tm.numpy()[:, None] >> bits) & 1)
    near = _near_threshold(pre, tmin, tmax, tt, offset, stride)
    assert not (differ & ~near).any()
    assert int(differ.sum()) == 0, f"{int(differ.sum())} cells at the threshold differ"
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(ttt.numpy(), np.asarray(jt))
    assert int(ttt.sum()) < int(tt.sum()), "the cull never fired"
    if case == "big_rects":
        assert int(tb.sum()) > 0 and (ttt.numpy()[tb.numpy()] == tt[tb.numpy()]).all()

    K = 4096
    j = jbinning.bin_gaussians_fast(
        jnp.asarray(tmin), jnp.asarray(tmax), jnp.asarray(tt), pre.depths, gx, gy, K,
        means2d=pre.means2d, lam_min=pre.lam_min, cull_c=pre.cull_c,
        tile_row_offset=offset, tile_row_stride=stride)
    t = tbinning.bin_gaussians_fast(
        _t(tmin), _t(tmax), _t(tt), _t(pre.depths), gx, gy, K,
        means2d=_t(pre.means2d), lam_min=_t(pre.lam_min), cull_c=_t(pre.cull_c),
        tile_row_offset=offset, tile_row_stride=stride)
    assert int(t.num_rendered) == int(j.num_rendered) == int(ttt.sum())
    for name in ("gauss_id", "tile_id", "tile_start", "tile_stop", "slot",
                 "seg_starts", "seg_counts", "order"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), err_msg=name)


@pytest.mark.parametrize("case", ["stretched", "big_rects"])
def test_preprocess_cull_bounds_match_jax(case):
    p, cam, _, _ = _scene(case)
    pre = _jax_pre(p, cam)
    tp = tpreprocess(*(_t(p[k]) for k in ("means3d", "scales", "rotations", "shs")),
                     _t(cam.camera_center), _t(cam.world_view), _t(cam.full_proj),
                     cam.tanfovx, cam.tanfovy, cam.width, cam.height, 3,
                     opacities=_t(p["opacities"]), cull_bounds=True)
    np.testing.assert_allclose(tp.lam_min.numpy(), np.asarray(pre.lam_min), rtol=2e-5,
                               atol=1e-9)
    np.testing.assert_allclose(tp.cull_c.numpy(), np.asarray(pre.cull_c), rtol=1e-6)
    for name in ("tile_min", "tile_max", "tiles_touched"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(pre, name)), err_msg=name)
    no_cull = tpreprocess(*(_t(p[k]) for k in ("means3d", "scales", "rotations", "shs")),
                          _t(cam.camera_center), _t(cam.world_view), _t(cam.full_proj),
                          cam.tanfovx, cam.tanfovy, cam.width, cam.height, 3,
                          opacities=_t(p["opacities"]))
    assert no_cull.lam_min is None and no_cull.cull_c is None


def _port_raster(p, cam, cull, opacities=None):
    """The port's render with gradients on; returns (out, grads of a fixed
    weighted sum with respect to the means2d carrier, opacities, SH and
    scales: the per-Gaussian payload gradients after the segment sum)."""
    leaves = {k: _t(p[k]).requires_grad_() for k in ("scales", "shs")}
    op = _t(p["opacities"] if opacities is None else opacities).requires_grad_()
    carrier = torch.zeros((len(p["means3d"]), 2), requires_grad=True)
    out = trasterize(_t(p["means3d"]), leaves["scales"], _t(p["rotations"]), op,
                     leaves["shs"], _t(cam.camera_center), _t(cam.world_view),
                     _t(cam.full_proj), cam.tanfovx, cam.tanfovy, cam.width,
                     cam.height, 3, torch.tensor(BG), 8192, means2d_offset=carrier,
                     ellipse_tile_cull=cull)
    w = torch.from_numpy(np.random.default_rng(3).uniform(
        -1, 1, tuple(out.color.shape)).astype(np.float32))
    grads = torch.autograd.grad((out.color * w).sum() + out.depth.sum(),
                                [carrier, op, leaves["shs"], leaves["scales"]])
    return out, grads


@pytest.mark.parametrize("case", ["stretched", "saturated"])
def test_cull_render_is_output_exact(case):
    if case == "stretched":
        p, cam, _, _ = _scene("stretched")
    else:   # opaque splats: pixels reach T_STOP
        cam = look_at_camera([0.1, -0.2, -4], [0, 0, 0], width=96, height=96)
        p = {k: np.array(v) for k, v in random_scene(24, seed=5, spread=0.9).items()}
        # round splats: a corner cell of a rect is dead now and then
        p["scales"][:] = 0.7 * p["scales"][:, :1]
        p["opacities"] = np.full((24,), 0.9, np.float32)
    off, g_off = _port_raster(p, cam, False)
    on, g_on = _port_raster(p, cam, True)
    assert int(on.num_rendered) < int(off.num_rendered)
    t_fin = np.minimum(1 - off.alpha.detach().numpy()[0], 1 - on.alpha.detach().numpy()[0])
    may_ride = t_fin < 1e-2        # T·(1 − α) < 1e-4 with α ≤ 0.99 needs T < 1e-2
    err = np.max(np.abs(np.concatenate([
        (on.color - off.color).detach().numpy(), (on.alpha - off.alpha).detach().numpy()])),
        axis=0)
    n_equal = int((err == 0).sum())
    n_ride = int(may_ride.sum())
    assert (err[~may_ride] <= 1e-6).all(), float(err[~may_ride].max())
    print(f"{case}: {n_equal} of {err.size} pixels bit-equal, {n_ride} may ride T_STOP, "
          f"{int((err > 1e-6).sum())} beyond 1e-6")
    if case == "stretched":
        assert n_ride == 0
        for a, b in zip(g_on, g_off):
            scale = float(b.abs().max())
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6 * max(scale, 1.0))
    else:
        assert 0 < n_ride < err.size


def test_cull_render_matches_jax_interpret():
    p, cam, _, _ = _scene("stretched")
    j = jrasterize(*(jnp.asarray(p[k]) for k in ("means3d", "scales", "rotations",
                                                  "opacities", "shs")),
                   jnp.array(cam.camera_center), jnp.array(cam.world_view),
                   jnp.array(cam.full_proj), cam.tanfovx, cam.tanfovy, cam.width,
                   cam.height, 3, jnp.asarray(BG), instance_budget=8192,
                   interpret=True, ellipse_tile_cull=True)
    with torch.no_grad():
        t = trasterize(*(_t(p[k]) for k in ("means3d", "scales", "rotations",
                                             "opacities", "shs")),
                       _t(cam.camera_center), _t(cam.world_view), _t(cam.full_proj),
                       cam.tanfovx, cam.tanfovy, cam.width, cam.height, 3,
                       torch.tensor(BG), 8192, ellipse_tile_cull=True)
    assert int(t.num_rendered) == int(j.num_rendered)
    assert int(t.max_tile_len) == int(j.max_tile_len)
    np.testing.assert_allclose(t.color.numpy(), np.asarray(j.color), atol=1e-4)
    np.testing.assert_allclose(t.alpha.numpy(), np.asarray(j.alpha), atol=1e-4)


def test_render_with_cull_config_matches_jax():
    """``render`` with ``cfg.tpu.ellipse_tile_cull`` (it raised before)
    against JAX's, on the ``_tiny_cfg`` scene (opacities ×0.1, as
    ``tests/test_torch_render.py``)."""
    cfg = _tiny_cfg()
    cfg.tpu.ellipse_tile_cull = True
    state = _tiny_scene(cfg)
    params = dict(state.params)
    params["opacity"] = params["opacity"] - 2.0
    state = state._replace(params=params)
    cam = JR.CameraArrays.from_camera(_camera(size=64))
    j = jax.jit(lambda prm: JR.render(prm, state, cam, cfg, 64, 64, "coarse",
                                      jnp.asarray(BG), active_sh_degree=1,
                                      backend="pallas"))(state.params)
    tstate = interop.from_jax_numpy(jax.tree.map(np.asarray, state.params),
                                    np.asarray(state.alive), np.asarray(state.aabb),
                                    cfg, device="cpu")
    with torch.no_grad():
        t = TR.render(tstate.params, tstate, TR.CameraArrays.from_camera(
            _camera(size=64), device="cpu"), cfg, 64, 64, "coarse", torch.tensor(BG), 1,
            device="cpu")
        cfg.tpu.ellipse_tile_cull = False
        plain = TR.render(tstate.params, tstate, TR.CameraArrays.from_camera(
            _camera(size=64), device="cpu"), cfg, 64, 64, "coarse", torch.tensor(BG), 1,
            device="cpu")
    assert int(t.num_rendered) == int(j.num_rendered) < int(plain.num_rendered)
    np.testing.assert_allclose(t.color.numpy(), np.asarray(j.color), atol=1e-4)
    np.testing.assert_allclose(t.depth.numpy(), np.asarray(j.depth), atol=2e-4)
    np.testing.assert_allclose(t.color.numpy(), plain.color.numpy(), atol=1e-6)
