"""The port's cost experiments (``fourdgs_tpu_torch/scripts``) on the CPU at
a tiny size (T = 8 tiles, a 4-wide grid, K = 4096 slots):

- each ``run(device="cpu", ...)`` returns its keys;
- ``exp_kernel_overhead``'s blend, forward and the gradient of
  ``out[:, :3].sum()``, against JAX's ``blend_pallas`` under the interpreter
  and ``jax.grad``, under the tolerances of ``tests/test_torch_blend*.py``;
- the JAX script's own backward line raises (the evidence for the driver's
  docstring);
- ``exp_gather``'s segment bookkeeping sums like ``index_add_``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs_tpu.ops import pallas_blend as PB
from fourdgs_tpu_torch import scripts
from fourdgs_tpu_torch.ops import blend
from fourdgs_tpu_torch.ops import grid_cost as G
from fourdgs_tpu_torch.ops.rasterize import payload_grad
from fourdgs_tpu_torch.scripts import exp_gather, exp_grid_cost
from fourdgs_tpu_torch.scripts import exp_kernel_overhead as EKO
from tests.test_torch_blend_backward import assert_rows_close
from tests.test_torch_math import warm_cpu_math  # noqa: F401  (autouse)

T, GX, K = 8, 4, 4096
CPU = torch.device("cpu")


@pytest.fixture
def one_call(monkeypatch):
    """Each timed variant called once, in one batch."""
    monkeypatch.setattr(scripts, "ITERS", 1)
    monkeypatch.setattr(scripts, "REPS", 1)


def test_exp_gather_run_returns_its_keys(one_call):
    res = exp_gather.run(device="cpu", P=512, K=K, render_K=2 * K, render_n_ids=500)
    assert res["device"] == "cpu" and res["clock"] == "host"
    variants = ("take_axis0_T", "take_axis1", "take_axis0", "scatter_add_bwd",
                "sort_segsum_bwd")
    want = ({f"script/{v}/{dt}" for v in variants for dt in ("float32", "bfloat16")}
            | {f"{s}/{v}/float32" for s in ("script", "render", "render_uniform")
               for v in ("gather_cols", "stage", "gather_pass", "write_out")}
            | {f"{s}/{v}/float32" for s in ("render", "render_uniform")
               for v in ("take_axis0_T", "take_axis1", "take_axis0")})
    assert set(res["ms"]) == want
    assert all(r["ms"] > 0 and r["wall_ms"] > 0 for r in res["rows"])


def test_exp_gather_render_ids_and_segment_sums():
    rng = np.random.default_rng(0)
    ids = exp_gather.render_ids(64, 1000, 300, rng, CPU)
    assert ids.dtype == torch.int32 and (ids[300:] == 0).all() and (ids[:300] < 64).all()
    g = torch.from_numpy(rng.standard_normal((16, 1000)).astype(np.float32))
    got = payload_grad(g, exp_gather.bins_for_ids(ids, 64), 64)
    want = torch.zeros(64, 16).index_add_(0, ids.long(), g.T)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_exp_grid_cost_run_returns_its_keys(one_call):
    res = exp_grid_cost.run(device="cpu", T=T)
    assert res["T"] == T and res["floor_ms"] > 0
    assert set(res["probes"]) == {p.fn.__name__ for p in G.PROBES}
    ones = {p.fn.__name__: p.ones for p in G.PROBES}
    for key, row in res["probes"].items():
        assert row["ms"] > 0
        # K4 parallel, K9 and K10 a block per 8 tiles, K7 per 4 (a warp
        # each), K8 per 2 pairs (a warp per pair)
        assert row["blocks"] == {"ones_sequential": None, "ones5_pairs": -(-T // 4),
                                 "ones5": -(-T // 4), "ones_parallel": -(-T // 8),
                                 "iota_px": -(-T // 8),
                                 "while_ones": -(-T // 8)}.get(key, T)
        # the same-bytes fill read in turns with every probe; it is the
        # torch.ones yardstick where it computes the same output
        assert row["fill_ms"] > 0 and row["vs_fill"] == row["ms"] / row["fill_ms"]
        if ones[key]:
            assert (row["ones_ms"], row["vs_ones"]) == (row["fill_ms"], row["vs_fill"])
        else:
            assert row["ones_ms"] is None and row["vs_ones"] is None
    assert {k for k, o in ones.items() if not o} == {"ones_three", "iota_px"}


def test_exp_grid_cost_reads_torch_ones_in_turns(monkeypatch):
    """Each probe is read in the order probe, ``torch.ones`` of its bytes,
    ``torch.ones``, probe; ``ms`` and ``fill_ms`` are the means of the two
    readings each and ``vs_fill`` their ratio. Where ``torch.ones`` computes
    the probe's output they are also ``ones_ms`` and ``vs_ones``; for K5 and
    K9, which no single call computes, those stay None."""
    ran = []

    def recording(p):
        def fn(*args):
            ran.append(p.fn.__name__)
            return p.fn(*args)

        fn.__name__ = p.fn.__name__
        return p._replace(fn=fn)

    probes = tuple(recording(p) for p in G.PROBES)
    monkeypatch.setattr(G, "PROBES", probes)
    # Probe.args knows K10 by its wrapper
    monkeypatch.setattr(G, "while_ones", next(p.fn for p in probes if p.id == "K10"))
    seq = []

    def fake_time_ms(fn, dev):
        n = len(ran)
        out = fn()
        v = float(len(seq) + 1) ** 2          # distinct readings 1, 4, 9, ...
        seq.append((ran[-1] if len(ran) > n else "ones", v))
        if len(ran) == n:                     # a fill: of the probe's bytes
            fills.append(tuple(out.shape))
        return v, v

    fills = []

    monkeypatch.setattr(exp_grid_cost, "time_ms", fake_time_ms)
    res = exp_grid_cost.run(device="cpu", T=T)
    assert res["floor_ms"] == 1.0 and seq[0][0] == "ones"   # the floor, K4 at T = 1
    assert fills[0] == (1, G.N, 1)
    i = 1
    for k, p in enumerate(G.PROBES):
        name, row = p.fn.__name__, res["probes"][p.fn.__name__]
        (a, va), (b, vb), (c, vc), (d, vd) = seq[i:i + 4]
        assert (a, b, c, d) == (name, "ones", "ones", name)
        assert fills[1 + 2 * k] == fills[2 + 2 * k] == (T, G.N, p.floats)
        assert row["ms"] == (va + vd) / 2 and row["fill_ms"] == (vb + vc) / 2
        assert row["vs_fill"] == row["ms"] / row["fill_ms"]
        if p.ones:
            assert (row["ones_ms"], row["vs_ones"]) == (row["fill_ms"], row["vs_fill"])
        else:
            assert p.id in ("K5", "K9")
            assert row["ones_ms"] is None and row["vs_ones"] is None
        i += 4
    assert i == len(seq)


def test_exp_kernel_overhead_run_returns_its_keys(one_call):
    with torch.no_grad():       # as chip_smoke.py calls it
        res = EKO.run(device="cpu", T=T, gx=GX, K=K)
    assert set(res["grids"]) == {"empty", "uniform98", "uniform128"}
    assert [res["grids"][g]["instances"] for g in ("empty", "uniform98", "uniform128")] == [
        0, 98 * T, 128 * T]
    assert set(res["per_tile_us"]) == {"fwd", "bwd", "fwd_bwd"}
    assert set(res["per_instance_ns"]) == {"uniform98", "uniform128"}
    with pytest.raises(ValueError, match="fewer than 128"):
        EKO.run(device="cpu", T=T, gx=GX, K=512)


@pytest.mark.parametrize("grid", ["uniform98", "uniform128"])
def test_exp_kernel_overhead_blend_matches_jax(grid):
    feat, starts, stops, row_off, bg, g_out = EKO.inputs(T, GX, K, CPU)[grid]
    j = [jnp.asarray(x.numpy()) for x in (feat, starts, stops, row_off, bg)]

    def fwd(f):
        return PB.blend_pallas(f, j[1], j[2], j[3], j[4], GX, T, K, True)

    want_out = np.asarray(fwd(j[0]))
    want_grad = np.asarray(jax.grad(lambda f: jnp.sum(fwd(f)[:, :3]))(j[0]))
    f = feat.clone().requires_grad_()
    out = blend.blend(f, starts, stops, row_off, bg, GX)
    (got_grad,) = torch.autograd.grad(out[:, :3].sum(), f)
    assert out[:, 4].min() < 0.9          # the tiles blend something
    # the split2 scan budget of the interpreted kernel (test_torch_blend.py)
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=5e-4)
    # test_torch_blend_backward.py::test_blend_vjp_matches_pallas_interpret
    assert_rows_close(got_grad.numpy(), want_grad, rtol=4e-3, atol=2e-4)
    # the K2 wrapper on the driver's cotangent gives the same gradient
    d = blend.blend_backward(feat, starts, stops, row_off, bg, out.detach(), g_out, GX)
    torch.testing.assert_close(d, got_grad, rtol=0, atol=0)


def test_jax_script_backward_line_raises():
    """``scripts/exp_kernel_overhead.py:62-64``, verbatim: ``blend_pallas``
    returns one packed [T, 5, 256] array, which does not unpack into three."""
    feat, starts, stops, row_off, bg, _ = EKO.inputs(T, GX, K, CPU)["uniform98"]
    jfeat, s, e, row, bgj = (jnp.asarray(x.numpy()) for x in (feat, starts, stops,
                                                               row_off, bg))

    def loss(ff):
        col, dep, _ = PB.blend_pallas(ff, s, e, row, bgj, GX, T, K, True)
        return jnp.sum(col)

    with pytest.raises(ValueError, match="too many values to unpack"):
        jax.grad(loss)(jfeat)
