"""The backward blend (K2's plain PyTorch version), the differentiable blend
and the per-Gaussian payload gradient, against the JAX package:

- ``blend_backward_plain`` against the independent NumPy simulation
  ``kernel_sim_backward`` and against ``jax.vjp`` of the Pallas
  ``blend_pallas`` under the interpreter, with the background cotangent;
- in the regime clear of ALPHA_CAP and T_STOP, against autograd of the
  forward's plain version (there the two must be the same function);
- the payload gather's backward against the VJP of the JAX
  ``_gathered_payload``, with NaN and ±inf rows and demand above the budget.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs_tpu.ops import pallas_blend as PB
from fourdgs_tpu.ops import rasterize as JRast
from fourdgs_tpu.ops.binning import bin_gaussians_fast as jbin
from fourdgs_tpu_torch.ops import blend
from fourdgs_tpu_torch.ops import rasterize as TRast
from fourdgs_tpu_torch.ops.binning import BinningOut
from tests.test_pallas_raster import kernel_sim_backward
from tests.test_torch_binning import _pre
from tests.test_torch_blend import _saturated_inputs, _straddle_inputs
from tests.test_torch_math import warm_cpu_math  # noqa: F401  (autouse)


def _multichunk_inputs(seed=5):
    """Tiles longer than one and than three chunks, an empty tile and a
    window that starts mid-block, on a 2-wide grid."""
    rng = np.random.default_rng(seed)
    gx, K = 2, 2048
    lens = np.array([130, 520, 0, 45, 300, 3])
    T = lens.size
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    stops = (starts + lens).astype(np.int32)
    tile = np.repeat(np.arange(T), lens)
    n = int(lens.sum())
    feat = np.zeros((PB.FEAT_ROWS, K), np.float32)
    feat[0, :n] = (tile % gx) * 16 + rng.uniform(-6, 22, n)
    feat[1, :n] = (tile // gx) * 16 + rng.uniform(-6, 22, n)
    feat[2, :n] = rng.uniform(0.01, 0.3, n)
    feat[3, :n] = rng.uniform(-0.05, 0.05, n)
    feat[4, :n] = rng.uniform(0.01, 0.3, n)
    feat[5, :n] = rng.uniform(0.002, 0.6, n)
    feat[6:10, :n] = rng.uniform(0, 1, (4, n))
    return feat, starts, stops, gx, T, K


CASES = {"straddle": _straddle_inputs, "saturated": _saturated_inputs,
         "multichunk": _multichunk_inputs}


def _torch_args(feat, starts, stops, row_off=(0, 1), bg=(0.0, 0.0, 0.0)):
    return (torch.tensor(np.ascontiguousarray(feat)), torch.tensor(starts),
            torch.tensor(stops), torch.tensor(row_off, dtype=torch.int32),
            torch.tensor(bg, dtype=torch.float32))


def assert_rows_close(got, want, rtol, atol, row_rel=2e-5):
    """allclose plus a slack of ``row_rel`` × the row's largest |value|.
    Each gradient is a float32 sum over a tile's 256 pixels of terms that
    cancel (the conic rows multiply by dx², up to ~10³ px²); two summation
    orders differ by up to ~256·2⁻²⁴ ≈ 1.5e-5 of the largest term, which
    the row's largest sum stands in for."""
    scale = np.abs(want).max(axis=1, keepdims=True)
    err = np.abs(got - want)
    tol = atol + rtol * np.abs(want) + row_rel * scale
    bad = err > tol
    assert not bad.any(), (
        f"{int(bad.sum())} of {bad.size} differ; worst excess "
        f"{float((err - tol).max()):.3g} at {np.unravel_index(np.argmax(err - tol), err.shape)}")


def _cotangent(T, seed):
    return np.random.default_rng(seed).uniform(-1, 1, (T, 5, 256)).astype(np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_kernel_sim(case):
    feat, starts, stops, gx, T, K = CASES[case]()
    args = _torch_args(feat, starts, stops)
    out = blend.blend_forward_plain(*args, gx)
    g = _cotangent(T, seed=1)
    got = blend.blend_backward(*args, out, torch.from_numpy(g), gx).numpy()
    sim = kernel_sim_backward(np.ascontiguousarray(feat), starts, stops,
                              g.transpose(0, 2, 1), gx, T)
    assert got.shape == (PB.FEAT_ROWS, K)
    # both scan in log space in float32: the tolerance of the JAX kernel
    # against this simulation (test_pallas_raster.py:386), plus the slack
    # of assert_rows_close for the saturated tiles' large conic sums
    assert_rows_close(got, sim, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got[10:], 0.0)
    covered = np.zeros(K, bool)
    for s, e in zip(starts, stops):
        covered[s:e] = True
    np.testing.assert_array_equal(got[:, ~covered], 0.0)
    assert np.abs(got[:10]).max() > 0


@pytest.mark.parametrize("case,row_off", [("straddle", (1, 2)),
                                          ("saturated", (0, 1)),
                                          ("multichunk", (0, 1))])
def test_blend_vjp_matches_pallas_interpret(case, row_off):
    feat, starts, stops, gx, T, K = (
        _saturated_inputs() if case == "saturated" else CASES[case](seed=3))
    feat = np.ascontiguousarray(feat)
    bg = (0.2, 0.5, 0.9)
    g = _cotangent(T, seed=2)
    _, vjp = jax.vjp(
        lambda f, b: PB.blend_pallas(
            f, jnp.asarray(starts), jnp.asarray(stops),
            jnp.asarray(row_off, np.int32), b, gx, T, K, True),
        jnp.asarray(feat), jnp.asarray(bg, np.float32))
    want_feat, want_bg = (np.asarray(x) for x in vjp(jnp.asarray(g)))

    f, s, e, r, b = _torch_args(feat, starts, stops, row_off, bg)
    f.requires_grad_()
    b.requires_grad_()
    out = blend.blend(f, s, e, r, b, gx)
    got_feat, got_bg = torch.autograd.grad(out, (f, b), torch.from_numpy(g))
    # the interpreted kernel scans the log transmittance with split-bf16
    # hi/lo matmuls (pallas_blend.py:137-161, ~1.4e-4 in log T), the plain
    # version exactly in f32; rtol/atol of test_pallas_raster.py:479-482,
    # plus the slack of assert_rows_close for the saturated tiles' sums
    assert_rows_close(got_feat.numpy(), want_feat, rtol=4e-3, atol=2e-4)
    np.testing.assert_allclose(got_bg.numpy(), want_bg, rtol=1e-3, atol=1e-3)


def test_plain_backward_is_the_forward_gradient():
    """Opacities ≤ 0.6 keep α below ALPHA_CAP and T far above T_STOP: there
    K2's formulas (α_raw uncapped) are the exact gradient of the forward."""
    feat, starts, stops, gx, T, K = _multichunk_inputs(seed=9)
    feat[5] *= 0.2
    f, s, e, r, b = _torch_args(feat, starts, stops, (0, 1), (0.3, 0.6, 0.1))
    f = f.double().requires_grad_()
    out = blend.blend_forward_plain(f, s, e, r, b.double(), gx)
    assert float(out.detach()[:, 4].min()) > 0.05
    g = torch.from_numpy(_cotangent(T, seed=4)).double()
    (want,) = torch.autograd.grad(out, f, g)
    got = blend.blend_backward_plain(f.detach().float(), s, e, r, b,
                                     out.detach().float(), g.float(), gx)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-5)


def _pairs_serial(feat, starts, stops, gx):
    """(kept, live): the in-range pairs that pass the gates and those that
    blend, walked as the CUDA kernels walk them: per pixel, the tile's
    instances in order in float32, T multiplied directly, a pixel frozen at
    T_STOP until its chunk ends."""
    K = feat.shape[1]
    f = np.ascontiguousarray(feat, np.float32)
    sub = np.arange(256)
    n_kept = n_live = 0
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
            gate = (power <= 0) & (alpha >= np.float32(1 / 255))
            keep = gate & ~frozen
            t_next = T * (np.float32(1) - alpha)
            live = keep & (t_next >= np.float32(1e-4))
            frozen |= keep & ~live
            T = np.where(live, t_next, T)
            n_kept += int(gate.sum())
            n_live += int(live.sum())
    return n_kept, n_live


@pytest.mark.parametrize("case", sorted(CASES))
def test_live_pairs_match_serial_walk(case):
    """The data-dependent work of the kernels' bounds. The plain walk takes
    T as a log-space prefix, the serial one as a direct product: a pixel
    that rides T_STOP may freeze one instance apart (the association
    contract), so the counts may differ by 0.1%."""
    feat, starts, stops, gx, T, K = CASES[case]()
    f, s, e, r, _ = _torch_args(feat, starts, stops)
    got = blend.pair_counts(f, s, e, r, gx)["live_pairs"]
    want = _pairs_serial(feat, starts, stops, gx)[1]
    assert 0 < want < 256 * int((stops - starts).sum())
    assert abs(got - want) <= 1e-3 * want, (got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_kept_pairs_match_serial_walk(case):
    """The pairs the bounds charge the gates to: every in-range pair that
    passes them, whatever T. No association enters the gates, so the counts
    agree but for an exp one ulp apart at the α floor; kept ≥ live, and the
    cull gates every kept pair and no more than the pairs in range."""
    feat, starts, stops, gx, T, K = CASES[case]()
    f, s, e, r, _ = _torch_args(feat, starts, stops)
    got = blend.pair_counts(f, s, e, r, gx)
    kept, live = _pairs_serial(feat, starts, stops, gx)
    assert abs(got["kept_pairs"] - kept) <= 1e-4 * kept, (got, kept)
    assert got["in_range"] == 256 * int((stops - starts).sum())
    assert got["in_range"] > got["gated"] >= got["kept_pairs"] >= got["live_pairs"] > 0
    assert kept >= live


def test_backward_wrapper_cpu_dispatch_and_checks():
    feat, starts, stops, gx, T, K = _straddle_inputs()
    args = list(_torch_args(feat, starts, stops))
    out = blend.blend_forward(*args, gx)
    g = torch.from_numpy(_cotangent(T, seed=0))
    before = blend.blend_backward.launches
    got = blend.blend_backward(*args, out, g, gx)
    assert blend.blend_backward.launches == before   # the plain version ran
    assert torch.equal(got, blend.blend_backward_plain(*args, out, g, gx))
    for bad_out, bad_g in [(out[:-1], g), (out, g.double()),
                           (out, g[:, :4].contiguous()),
                           (out, g.transpose(1, 2).contiguous().transpose(1, 2))]:
        with pytest.raises(ValueError):
            blend.blend_backward(*args, bad_out, bad_g, gx)


def _jax_payload_vjp(table, bins, d_feat):
    _, vjp = jax.vjp(
        lambda t: JRast._gathered_payload(
            t, bins.gauss_id, bins.slot, bins.seg_starts, bins.seg_counts,
            bins.order),
        jnp.asarray(table))
    return np.asarray(vjp(jnp.asarray(d_feat))[0])


def _bins(n, seed, budget_kind):
    """JAX binning of a random scene and the same bins as a port
    ``BinningOut``; the budget holds the demand or is half of it."""
    pre = _pre(n, seed=seed)
    demand = int(jnp.sum(pre.tiles_touched))
    K = 4096 if budget_kind == "fits" else 128 * (demand // 256)
    jb = jbin(pre.tile_min, pre.tile_max, pre.tiles_touched, pre.depths, 4, 4, K)
    tb = BinningOut(*(torch.from_numpy(np.array(x)).long() for x in (
        jb.gauss_id, jb.tile_id, jb.tile_start, jb.tile_stop, jb.num_rendered,
        jb.slot, jb.seg_starts, jb.seg_counts, jb.order)))
    return jb, tb, pre.depths.shape[0], K, min(demand, K)


def _port_payload_grad(table, tb, d_feat):
    t_table = torch.from_numpy(table).requires_grad_()
    feat = TRast._GatheredPayload.apply(t_table, tb)
    np.testing.assert_array_equal(feat.detach().numpy(),
                                  table[tb.gauss_id.numpy()].T)
    (got,) = torch.autograd.grad(feat, t_table, torch.from_numpy(d_feat))
    return got.numpy()


def _assert_sums_close(got, want, tb, d_feat, used):
    """Per-Gaussian sums of float32 terms in two orders. The port sums one
    segment at a time: off by at most 16·2⁻²⁴ of the sum of its terms'
    magnitudes (a Gaussian covers at most the 16 tiles of the 4×4 grid).
    JAX takes differences of compensated prefixes that run within 128-slot
    blocks (rasterize.py:32-81): off by a few 2⁻²⁴ of the largest such
    in-block prefix ``M``."""
    mag = np.zeros(got.shape)
    np.add.at(mag, tb.gauss_id.numpy()[:used],
              np.abs(d_feat[:, :used].T.astype(np.float64)))
    ordered = np.zeros_like(d_feat, dtype=np.float64)
    ordered[:, tb.slot.numpy()] = d_feat
    M = np.abs(np.cumsum(ordered.reshape(d_feat.shape[0], -1, 128), axis=2)).max()
    np.testing.assert_array_less(np.abs(got - want),
                                 2**-24 * (4 * M + 16 * mag) + 1e-30)


@pytest.mark.parametrize("budget_kind", ["fits", "overflows"])
def test_payload_grad_matches_jax(budget_kind):
    jb, tb, P, K, used = _bins(300, 4, budget_kind)
    rng = np.random.default_rng(7)
    table = rng.normal(size=(P, PB.FEAT_ROWS)).astype(np.float32)
    d_feat = rng.normal(size=(PB.FEAT_ROWS, K)).astype(np.float32)
    d_feat[:, used:] = 0.0                    # K2 leaves the padding slots 0
    got = _port_payload_grad(table, tb, d_feat)
    want = _jax_payload_vjp(table, jb, d_feat)
    _assert_sums_close(got, want, tb, d_feat, used)


def test_payload_grad_containment():
    """NaN → 0, ±inf → ±1e12, huge values clipped to ±1e12, as the JAX
    backward (rasterize.py:127-130), and no other Gaussian is touched."""
    jb, tb, P, K, used = _bins(300, 4, "fits")
    rng = np.random.default_rng(3)
    table = rng.normal(size=(P, PB.FEAT_ROWS)).astype(np.float32)
    d_feat = rng.normal(size=(PB.FEAT_ROWS, K)).astype(np.float32)
    d_feat[:, used:] = 0.0
    hits = {(2, 5): np.nan, (0, 17): np.inf, (7, 300): -np.inf, (4, 900): 3e13}
    for idx, v in hits.items():
        d_feat[idx] = v
    got = _port_payload_grad(table, tb, d_feat)
    want = _jax_payload_vjp(table, jb, d_feat)
    contained = np.clip(np.nan_to_num(d_feat, nan=0.0, posinf=1e12,
                                      neginf=-1e12), -1e12, 1e12)
    ref = np.zeros((P, PB.FEAT_ROWS))
    np.add.at(ref, tb.gauss_id.numpy()[:used], contained[:, :used].T.astype(np.float64))
    assert np.isfinite(got).all()
    _assert_sums_close(got, ref, tb, contained, used)
    # JAX's within-block float32 prefix (128 slots) carries a clamped 1e12
    # into the later slots of its block (1e12·2⁻²⁴ ≈ 6e4): compare with JAX
    # on the Gaussians whose slots share no block with a clamped entry
    slot = tb.slot.numpy()
    dirty_blocks = {slot[i] // 128 for (_, i) in hits}
    seg_s, seg_c, order = (x.numpy() for x in (tb.seg_starts, tb.seg_counts, tb.order))
    clean = np.ones(P, bool)
    for r in range(P):
        blocks = {b // 128 for b in range(seg_s[r], seg_s[r] + seg_c[r])}
        clean[order[r]] = not (blocks & dirty_blocks)
    assert 0.2 < clean.mean() < 1.0
    _assert_sums_close(np.where(clean[:, None], got, 0), np.where(clean[:, None], want, 0),
                       tb, contained, used)
    big = np.abs(ref) > 1e6
    assert big.sum() == 3      # the ±inf and the 3e13 (the NaN became 0)
    np.testing.assert_allclose(got[big], want[big], rtol=1e-6)


def test_payload_grad_is_deterministic_and_sums_segments():
    jb, tb, P, K, used = _bins(300, 8, "fits")
    d = torch.from_numpy(np.random.default_rng(0).normal(
        size=(PB.FEAT_ROWS, K)).astype(np.float32))
    d[:, used:] = 0.0
    a = TRast.payload_grad(d, tb, P)
    assert torch.equal(a, TRast.payload_grad(d.clone(), tb, P))
    # the same sums as a float64 scatter-add over the instances
    ref = torch.zeros((P, PB.FEAT_ROWS), dtype=torch.float64)
    ref.index_add_(0, tb.gauss_id[:used], d[:, :used].T.double())
    _assert_sums_close(a.numpy(), ref.numpy(), tb, d.numpy(), used)
