"""The bf16 payload (``cfg.tpu.payload_bf16``) of the port against the JAX
package's.

JAX casts the ``[P, 16]`` payload table to bfloat16 (``ops/rasterize.py:248``),
the blend's cotangent back to the payload's dtype
(``ops/pallas_blend.py:885-886``) and ``d_table`` to the cotangent's dtype
(``rasterize.py:142``). The port rounds the table through bfloat16 and keeps
it in float32 (``fourdgs_tpu_torch/ops/rasterize.py::round_bf16``), whose
autograd gives the third rounding, and rounds ``d_feat`` in the gather's
backward (the second).

- the rounding equals JAX's ``astype(bfloat16)`` bit for bit on the same
  float32 values;
- the tables of a render: where the two sides' float32 tables are equal,
  their bf16 tables are equal; elsewhere they differ by at most one bf16 ulp;
- ``render`` against ``fourdgs_tpu.render.render`` (the Pallas interpreter)
  and one ``make_train_step`` step against JAX's, both with the option on;
- ``bench_quality_torch.py`` trains with it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _camera
from fourdgs_tpu import render as JR
from fourdgs_tpu.ops import rasterize as jrast
from fourdgs_tpu.train import adam as jadam
from fourdgs_tpu.train import loop as jloop
from fourdgs_tpu_torch import interop
from fourdgs_tpu_torch import render as TR
from fourdgs_tpu_torch.ops import rasterize as trast
from fourdgs_tpu_torch.train import adam as tadam
from fourdgs_tpu_torch.train import loop as tloop
from tests.test_torch_math import warm_cpu_math  # noqa: F401  (autouse)
from tests.test_torch_cli import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_render import BG, SIZE, _scene
from tests.test_torch_train import _leaves_close, _port_state, _setup, _t


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bfloat16 at |x| (8 significand bits)."""
    return np.spacing(np.abs(x).astype(np.float32)) * 2.0 ** 16


def test_rounding_matches_jax_astype():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.normal(size=4096).astype(np.float32) * 10.0 ** rng.integers(-30, 30, 4096),
        # exact ties between two bf16 values (round half to even), the
        # largest finite values, subnormals, zeros and non-finite values
        ((0x3F00 + np.arange(256, dtype=np.uint32)) << 16 | 0x8000).view(np.float32),
        -((0x3F00 + np.arange(256, dtype=np.uint32)) << 16 | 0x8000).view(np.float32),
        np.array([3.3895e38, -3.3895e38, np.finfo(np.float32).max, 1e-40, -1e-45,
                  0.0, -0.0, np.inf, -np.inf], np.float32),
    ]).astype(np.float32)
    got = trast.round_bf16(torch.from_numpy(x)).numpy()
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    nan = np.float32(np.nan)
    assert np.isnan(trast.round_bf16(torch.tensor([nan])).numpy()).all()


def _capture(monkeypatch, module, jax_side):
    """Wrap ``module.build_table`` to record each float32 table it builds."""
    tables = []
    build = module.build_table
    if jax_side:
        def wrapped(pre, opac, means2d, payload_dtype=jnp.float32):
            t = build(pre, opac, means2d, jnp.float32)
            jax.debug.callback(lambda a: tables.append(np.asarray(a)), t)
            return t.astype(payload_dtype)
    else:
        def wrapped(pre, opac, means2d):
            t = build(pre, opac, means2d)
            tables.append(t.detach().numpy().copy())
            return t
    monkeypatch.setattr(module, "build_table", wrapped)
    return tables


@pytest.mark.parametrize("stage,time", [("fine", 0.3), ("coarse", 0.3)])
def test_render_bf16_matches_jax(monkeypatch, stage, time):
    cfg, state = _scene()
    cfg.tpu.payload_bf16 = True
    j_tables = _capture(monkeypatch, jrast, jax_side=True)
    t_tables = _capture(monkeypatch, trast, jax_side=False)
    jcam = JR.CameraArrays.from_camera(_camera(time=time, size=SIZE))
    j = jax.jit(lambda p: JR.render(p, state, jcam, cfg, SIZE, SIZE, stage,
                                    jnp.asarray(BG), active_sh_degree=1,
                                    backend="pallas"))(state.params)
    tstate = interop.from_jax_numpy(jax.tree.map(np.asarray, state.params),
                                    np.asarray(state.alive), np.asarray(state.aabb),
                                    cfg, device="cpu")
    tcam = TR.CameraArrays.from_camera(_camera(time=time, size=SIZE), device="cpu")
    with torch.no_grad():
        t = TR.render(tstate.params, tstate, tcam, cfg, SIZE, SIZE, stage,
                      torch.tensor(BG), active_sh_degree=1, device="cpu")
    (jt,), (tt,) = j_tables, t_tables
    jb = np.asarray(jnp.asarray(jt).astype(jnp.bfloat16).astype(jnp.float32))
    tb = trast.round_bf16(torch.from_numpy(tt)).numpy()
    # The tables' float32 values come from two implementations of the same
    # projection and differ by float32 rounding in some elements (more, in
    # relative terms, where a conic term cancels near 0). Each side's bf16
    # value lies within half a bf16 ulp of its float32 value, so equal
    # float32 gives equal bf16, and elsewhere the bf16 values differ by at
    # most the float32 difference plus one bf16 ulp.
    same = _bits(tt) == _bits(jt)
    np.testing.assert_array_equal(_bits(tb)[same], _bits(jb)[same])
    bound = np.abs(tt - jt) + _bf16_ulp(np.maximum(np.abs(tt), np.abs(jt)))
    assert np.all(np.abs(tb - jb) <= bound), np.abs(tb - jb).max()
    # Measured: of the live rows, one element takes another bf16 value (a
    # conic's b of 8.1e-6 beside a and c of 3.3, one bf16 ulp of 6e-8 apart,
    # in the coarse case); the renders agree within the float32 test's
    # bounds (test_torch_render.py).
    np.testing.assert_allclose(t.color.numpy(), np.asarray(j.color), atol=1e-4)
    np.testing.assert_allclose(t.alpha.numpy(), np.asarray(j.alpha), atol=1e-4)
    np.testing.assert_allclose(t.depth.numpy(), np.asarray(j.depth), atol=2e-4)
    assert int(t.num_rendered) == int(j.num_rendered) > 0
    # the rounding moved the render: bf16 is not the float32 path
    cfg.tpu.payload_bf16 = False
    with torch.no_grad():
        t32 = TR.render(tstate.params, tstate, tcam, cfg, SIZE, SIZE, stage,
                        torch.tensor(BG), active_sh_degree=1, device="cpu")
    assert float((t32.color - t.color).abs().max()) > 1e-4


def test_payload_gradient_bf16_matches_jax():
    """Sites 2 and 3 against JAX's ``_gathered_payload`` VJP on the same
    binning: a random cotangent ``d_feat`` through the port's gather of a
    bf16 table (the autograd of :func:`round_bf16` included) and through
    JAX's custom VJP of the bf16 table."""
    cfg, state = _scene()
    tstate = interop.from_jax_numpy(jax.tree.map(np.asarray, state.params),
                                    np.asarray(state.alive), np.asarray(state.aabb),
                                    cfg, device="cpu")
    tcam = TR.CameraArrays.from_camera(_camera(size=SIZE), device="cpu")
    with torch.no_grad():
        xyz, sc, rot, op, shs, _ = TR.activated_gaussians(tstate.params, tstate,
                                                          tcam, "fine")
    table = None

    def hooked(*args):
        nonlocal table
        table = trast.build_table.__wrapped__(*args).detach().requires_grad_()
        return table

    hooked.__wrapped__ = trast.build_table
    mp = pytest.MonkeyPatch()
    mp.setattr(trast, "build_table", hooked)
    try:
        bi = trast.blend_inputs(xyz, sc, rot, op, shs, tcam.camera_center,
                                tcam.world_view, tcam.full_proj, tcam.tanfovx,
                                tcam.tanfovy, SIZE, SIZE, 1, cfg.tpu.instance_budget,
                                alive=tstate.alive, payload_bf16=True)
    finally:
        mp.undo()
    d_feat = torch.from_numpy(np.random.default_rng(4).normal(
        size=tuple(bi.feat.shape)).astype(np.float32))
    (got,) = torch.autograd.grad(bi.feat, table, d_feat)
    got = got.numpy()
    b = bi.bins
    ints = [jnp.asarray(x.numpy().astype(np.int32)) for x in (
        b.gauss_id, b.slot, b.seg_starts, b.seg_counts, b.order)]

    @jax.jit
    def jax_d_table(t, ct):
        _, vjp = jax.vjp(lambda t: jrast._gathered_payload(t, *ints), t)
        return vjp(ct)[0].astype(jnp.float32)

    want = np.asarray(jax_d_table(
        jnp.asarray(table.detach().numpy()).astype(jnp.bfloat16),
        jnp.asarray(d_feat.numpy()).astype(jnp.bfloat16)))
    # every element of the port's d_table is a bf16 value (site 3)
    np.testing.assert_array_equal(_bits(trast.round_bf16(torch.from_numpy(got))),
                                  _bits(got))
    # Both sides sum the same bf16-rounded d_feat (site 2) per Gaussian in
    # float32, JAX compensated and the port plain, so the float32 sums
    # differ by float32 rounding and, rounded to bf16, are equal unless they
    # straddle a midpoint between two bf16 values: at most one bf16 ulp.
    assert np.all(np.abs(got - want) <= _bf16_ulp(np.maximum(np.abs(got), np.abs(want))))
    assert (got == want).mean() > 0.99, (got == want).mean()
    assert np.abs(want).max() > 0
    # without the rounding of d_feat the sums differ beyond that
    plain = trast.payload_grad(d_feat, b, table.shape[0]).numpy()
    assert (plain != want)[want != 0].mean() > 0.5


CASE = "fine-padded-uint8"


@functools.cache
def _jax_bf16_step1():
    """``_setup(CASE)`` with the bf16 payload, and JAX's step 1 from it;
    once per process (the step program compiles under the interpreter)."""
    cfg, stage, w, h, jstate, jcams, tcams, gts = setup = _setup(CASE)
    cfg.tpu.payload_bf16 = True
    jstep = jloop.make_train_step(cfg, w, h, stage, active_sh_degree=1)
    return setup, jstep(jstate.params, jadam.init(jstate.params), jstate, jcams,
                        jnp.asarray(gts), 1)


def test_train_step_bf16_matches_jax():
    (cfg, stage, w, h, jstate, _, tcams, gts), (_, ja1, js1, jm1) = _jax_bf16_step1()
    tstep = tloop.make_train_step(cfg, w, h, stage, 1, device="cpu")
    tstate = _port_state(jstate, cfg)
    _, ta1, ts1, tm1 = tstep(tstate.params, tadam.init(tstate.params), tstate,
                             tcams, _t(gts), 1)
    for k in ("num_rendered", "max_tile_len", "n_points"):
        assert int(tm1[k]) == int(jm1[k]), k
    for k in ("loss", "l1", "psnr"):
        np.testing.assert_allclose(float(tm1[k]), float(jm1[k]), rtol=1e-5, err_msg=k)
    mu, nu, count = interop.adam_to_numpy(ta1)
    assert count == int(ja1.count) == 1
    _leaves_close(mu, ja1.mu, 4e-3, 2e-3, "mu")
    _leaves_close(nu, ja1.nu, 8e-3, 4e-3, "nu")
    for k in ("max_radii2d", "denom"):
        np.testing.assert_array_equal(getattr(ts1, k).numpy(),
                                      np.asarray(getattr(js1, k)), err_msg=k)


def test_quality_bench_trains_bf16():
    """``bench_quality_torch.configure`` sets the bf16 payload, as
    ``bench_quality.py:164`` does."""
    import bench_quality_torch as TB
    from fourdgs_tpu_torch.configs.core import load_config

    cfg = load_config(TB.PRESET)
    assert not cfg.tpu.payload_bf16
    TB.configure(cfg, 0.05)
    assert cfg.tpu.payload_bf16
