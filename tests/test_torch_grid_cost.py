"""K4–K10, the grid-cost probes: each wrapper of
``fourdgs_tpu_torch.ops.grid_cost`` on the CPU (its plain version) against
the JAX kernel of ``scripts/exp_grid_cost.py`` rebuilt under the Pallas
interpreter at T = 8. The bodies are copied verbatim (the script defines them
inside ``main``); the outputs are constants and iotas, so the tolerance is 0.
K6's JAX kernel fails at trace time (the script never calls it: it rebinds
``f5`` first); the port's K6 gives K7's output."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from fourdgs_tpu_torch.ops import grid_cost as G

T = 8
N = 256


def blk(ch):
    # exp_grid_cost.py:44-46
    return pl.BlockSpec((1, N, ch), lambda t, *_: (t, 0, 0),
                        memory_space=pltpu.VMEM)


def _params(sem):
    return pltpu.CompilerParams(dimension_semantics=(sem,))


# -- the JAX kernels, verbatim ---------------------------------------------


def k1(o):
    # exp_grid_cost.py:49-50
    o[0] = jnp.ones((N, 1), jnp.float32)


def k3(a, b, c):
    # exp_grid_cost.py:62-65
    a[0] = jnp.ones((N, 3), jnp.float32)
    b[0] = jnp.ones((N, 1), jnp.float32)
    c[0] = jnp.ones((N, 1), jnp.float32)


def k5(o):
    # exp_grid_cost.py:85-86
    o[0] = jnp.ones((N, 5), jnp.float32)


def kp(o):
    # exp_grid_cost.py:97-98
    o[:] = jnp.ones((2, N, 5), jnp.float32)


def kw(o):
    # exp_grid_cost.py:111-117
    i = jax.lax.broadcasted_iota(jnp.int32, (128, 128), 0)
    j = jax.lax.broadcasted_iota(jnp.int32, (128, 128), 1)
    tri = (i < j).astype(jnp.float32)
    sub = jax.lax.broadcasted_iota(jnp.int32, (N, 1), 0)
    px = (sub % 16).astype(jnp.float32)
    o[0] = px + tri[0:1, 0:1] * jnp.ones((N, 1), jnp.float32)


def kwl(s_ref, o):
    # exp_grid_cost.py:128-139
    t = pl.program_id(0)
    start = s_ref[t]

    def cond(c):
        return c < start

    def body(c):
        return c + 1

    jax.lax.while_loop(cond, body, jnp.int32(0))
    o[0] = jnp.ones((N, 1), jnp.float32)


def _f32(*shapes):
    outs = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return outs if len(outs) > 1 else outs[0]


def jax_probe(name, s=None, T=T):
    """The script's ``pallas_call`` of each probe (calls :53, :67, :78, :88,
    :100, :119, :146) over a grid of ``T`` tiles (K10: ``len(s)``), with
    ``interpret=True``."""
    if name in ("ones_parallel", "ones_sequential"):
        sem = "parallel" if name == "ones_parallel" else "arbitrary"
        f = pl.pallas_call(k1, grid=(T,), out_specs=blk(1), out_shape=_f32((T, N, 1)),
                           compiler_params=_params(sem), interpret=True)
        return f()
    if name == "ones_three":
        f = pl.pallas_call(k3, grid=(T,), out_specs=[blk(3), blk(1), blk(1)],
                           out_shape=_f32((T, N, 3), (T, N, 1), (T, N, 1)),
                           compiler_params=_params("arbitrary"), interpret=True)
        return f()
    if name == "ones_broadcast5":
        f = pl.pallas_call(k1, grid=(T,), out_specs=blk(5), out_shape=_f32((T, N, 5)),
                           compiler_params=_params("arbitrary"), interpret=True)
        return f()
    if name == "ones5":
        f = pl.pallas_call(k5, grid=(T,), out_specs=blk(5), out_shape=_f32((T, N, 5)),
                           compiler_params=_params("arbitrary"), interpret=True)
        return f()
    if name == "ones5_pairs":
        f = pl.pallas_call(
            kp, grid=(T // 2,),
            out_specs=pl.BlockSpec((2, N, 5), lambda t, *_: (t, 0, 0),
                                   memory_space=pltpu.VMEM),
            out_shape=_f32((T, N, 5)), compiler_params=_params("arbitrary"),
            interpret=True)
        return f()
    if name == "iota_px":
        f = pl.pallas_call(kw, grid=(T,), out_specs=blk(1), out_shape=_f32((T, N, 1)),
                           compiler_params=_params("arbitrary"), interpret=True)
        return f()
    assert name == "while_ones"
    T = len(s)
    gs = pltpu.PrefetchScalarGridSpec(num_scalar_prefetch=1, grid=(T,), in_specs=[],
                                      out_specs=blk(1))
    f = pl.pallas_call(kwl, grid_spec=gs, out_shape=_f32((T, N, 1)),
                       compiler_params=_params("arbitrary"), interpret=True)
    return jax.jit(f)(jnp.asarray(s))


@pytest.mark.parametrize("name", ["ones_parallel", "ones_sequential", "ones_three",
                                  "ones5", "ones5_pairs", "iota_px", "while_ones"])
def test_probe_matches_jax_kernel(name):
    fn = getattr(G, name)
    before = fn.launches
    if name == "while_ones":
        s = np.arange(T, dtype=np.int32)          # nonzero loop counts
        got = fn(torch.from_numpy(s))
        want = jax_probe(name, s)
    else:
        got = fn(T, device="cpu")
        want = jax_probe(name)
    assert fn.launches == before                   # the plain version ran
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("t", [1, 7, 16])
def test_iota_px_matches_jax_kernel_at_the_grid_edges(t):
    """K9 at a part-filled block of 8 tiles (1, 7) and at whole blocks (16):
    the port's plain version bit for bit against the JAX kernel's triangle
    and iotas, over a grid of t steps."""
    before = G.iota_px.launches
    got = G.iota_px(t, device="cpu")
    assert got.shape == (t, N, 1) and G.iota_px.launches == before
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_probe("iota_px", T=t)))


@pytest.mark.parametrize("counts", ["zero", "t % 7", "(t % 7) - 3", "-5"])
def test_while_ones_loop_counts_match_jax(counts):
    """K10 with zero, positive, mixed negative and all negative loop counts:
    the port's plain version against the JAX kernel, which writes ones
    whatever the loop ran."""
    t = np.arange(T, dtype=np.int32)
    s = {"zero": 0 * t, "t % 7": t % 7, "(t % 7) - 3": t % 7 - 3, "-5": t * 0 - 5}[counts]
    got = G.while_ones(torch.from_numpy(s.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_probe("while_ones", s)))


def test_check_args_cover_the_grid_edges():
    """Each probe's chip-check arguments run on the CPU (their plain
    versions) and reach, for a grid of several tiles per block, a T that ends
    in a part-filled block and one (16) that fills whole blocks: K8 a last
    block of pairs half full (2 and 2,502 tiles) and whole blocks of pairs;
    K9 and K10 are warp grids of 8 tiles a block; K10 gets negative loop
    counts."""
    cpu = torch.device("cpu")
    assert 16 in G.EDGE_TILES
    assert {p.id for p in G.PROBES if p.grid == "warp"} == {"K4", "K9", "K10"}
    for p in G.PROBES:
        cases = p.check_args(cpu)
        tiles = [len(a[0]) if isinstance(a[0], torch.Tensor) else a[0] for a in cases]
        if p.grid == "warp_pair":
            assert all(t % 2 == 0 for t in tiles)
            pairs_per_block = G.TILES_PER_BLOCK[p.grid] // 2
            assert any((t // 2) % pairs_per_block for t in tiles), p.id
            assert any((t // 2) % pairs_per_block == 0 for t in tiles), p.id
        if p.grid in ("warp", "warp4", "warp_pair"):
            assert any(t % G.TILES_PER_BLOCK[p.grid] for t in tiles), p.id
            assert 16 in tiles and 16 % G.TILES_PER_BLOCK[p.grid] == 0, p.id
        for args, t in zip(cases, tiles):
            out = p.fn(*args)
            for o in out if isinstance(out, tuple) else (out,):
                assert o.shape[0] == t, p.id
    loops = [a[0] for a in G.PROBES[-1].check_args(cpu)]
    assert G.PROBES[-1].fn is G.while_ones and any(bool((s < 0).any()) for s in loops)


def test_k6_jax_kernel_fails_at_trace_and_port_gives_k7():
    """exp_grid_cost.py:78 stores ``k1``'s (256, 1) value into a (256, 5)
    block; the trace rejects the store. The port's K6 broadcasts the value,
    which is K7's output."""
    with pytest.raises(ValueError, match="shape"):
        jax_probe("ones_broadcast5")
    got = G.ones_broadcast5(T, device="cpu").numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_probe("ones5")))
    np.testing.assert_array_equal(got, G.ones5(T, device="cpu").numpy())


def test_probe_wrapper_checks():
    with pytest.raises(ValueError, match="even"):
        G.ones5_pairs(7, device="cpu")
    with pytest.raises(ValueError):
        G.ones_parallel(-1, device="cpu")
    with pytest.raises(ValueError):
        G.while_ones(torch.zeros(T, dtype=torch.int64))
    for p in G.PROBES:
        out = p.fn(*p.args(0, torch.device("cpu")))
        for o in out if isinstance(out, tuple) else (out,):
            assert o.shape[0] == 0


@pytest.mark.parametrize("t", [1, 7, 8, 9, 2500, 2501])
def test_k4_blocks_follow_the_new_grids(monkeypatch, t):
    """K4 "parallel" launches a block per 8 tiles (a warp each), "arbitrary"
    one persistent block per SM but no more than those: at 132 SMs, 313 and
    132 blocks at T = 2,500. Off the card "arbitrary" has no SM count."""
    cpu = torch.device("cpu")
    par, seq = (p for p in G.PROBES if p.id == "K4")
    assert (par.fn, seq.fn) == (G.ones_parallel, G.ones_sequential)
    assert par.blocks(t, cpu) == -(-t // 8)
    assert seq.blocks(t, cpu) is None
    monkeypatch.setattr(G, "sm_count", lambda dev: 132)
    assert seq.blocks(t, cpu) == min(132, -(-t // 8))


@pytest.mark.parametrize("t", [2, 8, 16, 18, 2500, 2502])
def test_k7_k8_blocks_follow_the_new_grids(t):
    """K7 launches a block per 4 tiles (a warp each), K8 a block per 2 pairs
    of tiles (a warp per pair): ceil(T / 4) blocks each, 625 at T = 2,500."""
    cpu = torch.device("cpu")
    k7, k8 = (next(p for p in G.PROBES if p.id == i) for i in ("K7", "K8"))
    assert (k7.fn, k8.fn) == (G.ones5, G.ones5_pairs)
    assert k7.blocks(t, cpu) == -(-t // 4)
    assert k8.blocks(t, cpu) == -(-(t // 2) // 2) == -(-t // 4)
    assert k7.blocks(2500, cpu) == k8.blocks(2500, cpu) == 625


@pytest.mark.parametrize("t", [1, 7, 2500, 2501])
def test_k9_blocks_follow_the_new_grid(t):
    """K9 launches K4 "parallel"'s grid: a block per 8 tiles, a warp each,
    313 blocks at T = 2,500."""
    k9 = next(p for p in G.PROBES if p.id == "K9")
    assert k9.fn is G.iota_px and k9.grid == "warp"
    assert k9.blocks(t, torch.device("cpu")) == -(-t // 8)
    assert k9.blocks(2500, torch.device("cpu")) == 313


def test_probe_table_matches_the_outputs():
    """Each row of ``PROBES`` against its plain version's output: the floats
    per pixel (the bound of chip_smoke.py), the ``torch.ones`` yardstick,
    and the blocks of one launch."""
    cpu = torch.device("cpu")
    assert len({p.fn for p in G.PROBES}) == len(G.PROBES) == 8
    for p in G.PROBES:
        out = p.plain(*p.args(T, cpu))
        outs = out if isinstance(out, tuple) else (out,)
        assert all(o.shape[:2] == (T, N) for o in outs), p.id
        assert sum(o.shape[2] for o in outs) == p.floats, p.id
        if p.ones:
            torch.testing.assert_close(out, torch.ones((T, N, p.floats)), rtol=0, atol=0)
        else:
            assert not (len(outs) == 1 and bool((outs[0] == 1).all())), p.id
        for t in (T, 7, 2501):
            if p.grid == "warp_pair" and t % 2:
                continue        # K8 takes an even T
            want = {"tile": t, "warp": -(-t // 8), "warp4": -(-t // 4),
                    "warp_pair": -(-(t // 2) // 2), "sm": None}[p.grid]
            assert p.blocks(t, cpu) == want, (p.id, t)
        assert p.site.startswith("scripts/exp_grid_cost.py:"), p.id
