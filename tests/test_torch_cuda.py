"""The CUDA kernels against their plain PyTorch versions, on the card: the
blend kernels (K1 forward, K2 backward), the column gather (K3) and the
grid-cost probes (K4–K10); and K1 and K2 with their per-warp cull against
their walk of every in-range instance, bit for bit, and the strip masks
they stage against their plain mirror.

Skips without CUDA. It imports no JAX, so it runs where only PyTorch is
installed; the repository's conftest imports JAX, hence on such a machine:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from chip_smoke import (GATHER_EDGE_K, GATHER_EDGE_P, blend_work, check_gather,
                        check_gather_back_to_back, check_gather_ranges, check_probe,
                        compare_blend, compare_blend_backward, cull_edge_inputs,
                        gather_edge_inputs, synthetic_blend_inputs)
from fourdgs_tpu_torch.ops import blend, gather, grid_cost

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_matches_plain(cuda_device, seed):
    args = synthetic_blend_inputs(cuda_device, seed=seed)
    before = blend.blend_forward.launches
    out = blend.blend_forward(*args)
    torch.cuda.synchronize()
    assert blend.blend_forward.launches == before + 1
    ref = blend.blend_forward_plain(*args)
    res = compare_blend(out, ref)
    assert res["max_color_err"] < 1e-2


def test_kernel_rejects_cpu_mix(cuda_device):
    feat, starts, stops, row_off, bg, gx = synthetic_blend_inputs(cuda_device)
    with pytest.raises(ValueError):
        blend.blend_forward(feat, starts.cpu(), stops, row_off, bg, gx)


@pytest.mark.parametrize("seed", [0, 1])
def test_backward_kernel_matches_plain(cuda_device, seed):
    feat, starts, stops, row_off, bg, gx = synthetic_blend_inputs(cuda_device, seed=seed)
    out = blend.blend_forward(feat, starts, stops, row_off, bg, gx)
    gen = torch.Generator(device=cuda_device).manual_seed(seed)
    g = torch.rand(out.shape, generator=gen, device=cuda_device) * 2 - 1
    before = blend.blend_backward.launches
    d = blend.blend_backward(feat, starts, stops, row_off, bg, out, g, gx)
    torch.cuda.synchronize()
    assert blend.blend_backward.launches == before + 1
    ref = blend.blend_backward_plain(feat, starts, stops, row_off, bg, out, g, gx)
    res = compare_blend_backward(
        d, ref, blend_work(feat, starts, stops, row_off, gx)["instances"])
    assert res["instances_over_tol"] == 0
    # every run gives the same bits: one block per tile, fixed sum order
    assert torch.equal(d, blend.blend_backward(feat, starts, stops, row_off, bg, out, g, gx))


@pytest.mark.parametrize("inputs", ["synthetic", "cull_edges"])
@pytest.mark.parametrize("seed", [0, 1])
def test_cull_is_exact(cuda_device, seed, inputs):
    """K1 and K2 with their per-warp cull give the bits of their walk of
    every in-range instance (the ``_cull=False`` test hook)."""
    if inputs == "synthetic":
        args = synthetic_blend_inputs(cuda_device, seed=seed)
        out = blend.blend_forward(*args)
        gen = torch.Generator(device=cuda_device).manual_seed(seed)
        g = torch.rand(out.shape, generator=gen, device=cuda_device) * 2 - 1
    else:
        *args, g = cull_edge_inputs(cuda_device, seed=seed)
        out = blend.blend_forward(*args)
    assert torch.equal(out, blend.blend_forward(*args, _cull=False))
    bwd = (*args[:5], out, g, args[5])
    d = blend.blend_backward(*bwd)
    assert torch.equal(d, blend.blend_backward(*bwd, _cull=False))
    assert torch.equal(d, blend.blend_backward(*bwd))


@pytest.mark.parametrize("inputs", ["synthetic", "cull_edges"])
@pytest.mark.parametrize("seed", [0, 1])
def test_strip_masks_match_plain(cuda_device, seed, inputs):
    """The strip masks the kernels stage are their plain mirror's, slot for
    slot, so the CPU's proofs of the mirror and the gated counts hold for
    the kernels."""
    if inputs == "synthetic":
        args = synthetic_blend_inputs(cuda_device, seed=seed)
    else:
        args = cull_edge_inputs(cuda_device, seed=seed)[:6]
    feat, starts, stops, row_off, _, gx = args
    before = blend.blend_forward.launches
    got = blend.strip_masks(feat, starts, stops, row_off, gx)
    torch.cuda.synchronize()
    assert blend.blend_forward.launches == before
    want = blend.strip_masks_plain(*(x.cpu() for x in (feat, starts, stops, row_off)), gx)
    assert torch.equal(got.cpu(), want)
    assert bool(((want > 0) & (want < blend.ALL_STRIPS)).any())   # some cull


def test_blend_autograd_runs_both_kernels(cuda_device):
    feat, starts, stops, row_off, bg, gx = synthetic_blend_inputs(cuda_device)
    feat.requires_grad_()
    before = (blend.blend_forward.launches, blend.blend_backward.launches)
    out = blend.blend(feat, starts, stops, row_off, bg, gx)
    (d,) = torch.autograd.grad(out[:, :3].sum(), feat)
    assert (blend.blend_forward.launches, blend.blend_backward.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.isfinite(d).all() and d.abs().max() > 0


@pytest.mark.parametrize("K", [393_216, 2_097_152])
def test_gather_kernel_matches_plain(cuda_device, K):
    gen = torch.Generator().manual_seed(K)
    P = 65_536
    table = torch.randn(16, P, generator=gen).to(cuda_device)
    idx = torch.randint(0, P, (K,), generator=gen, dtype=torch.int32)
    idx[K // 2:] = 0          # the render's padding id
    idx[:3] = P - 1
    idx = idx.to(cuda_device)
    before = gather.gather_cols.launches
    out = gather.gather_cols(table, idx)
    torch.cuda.synchronize()
    assert gather.gather_cols.launches == before + 1
    assert torch.equal(out, gather.gather_cols_plain(table, idx))
    with pytest.raises(ValueError):
        gather.gather_cols(table, idx.cpu())


@pytest.mark.parametrize("K", GATHER_EDGE_K)
@pytest.mark.parametrize("P", GATHER_EDGE_P)
def test_gather_kernel_edges(cuda_device, P, K):
    """K3 (staging, then gather) bit-equal to ``index_select(1)`` where P is
    no multiple of the staging pass's columns and K none of a warp's slots,
    ids P − 1 and 0 included; one launch counted."""
    check_gather(*gather_edge_inputs(P, K, cuda_device))


def test_gather_kernel_out_of_range_and_empty(cuda_device):
    """NaN columns for ids −1 and P; K = 0 gives [16, 0] and launches
    nothing."""
    check_gather_ranges(cuda_device)


def test_gather_kernel_back_to_back(cuda_device):
    """The gather pass launches while the staging pass runs and waits for
    its rows: calls queued back to back on other tables in one scratch
    never read the previous call's rows."""
    check_gather_back_to_back(cuda_device)


@pytest.mark.parametrize("P", [17, 65_537])
def test_gather_pass_hooks(cuda_device, P):
    """The staging hook is ``table.T``; the gather hook on that [P, 16]
    table is ``index_select(0).T`` (the render path's gather), NaN for ids
    outside [0, P); neither counts as a K3 call."""
    table, idx = gather_edge_inputs(P, 393_216, cuda_device)
    before = gather.gather_cols.launches
    rows = gather._stage_rows(table)
    assert torch.equal(rows, table.T.contiguous())
    want = rows.index_select(0, idx).T
    bad = idx.clone()
    bad[7], bad[8] = -1, P
    got = gather._gather_rows(rows, idx)
    torch.cuda.synchronize()
    assert got.is_contiguous() and torch.equal(got, want)
    got = gather._gather_rows(rows, bad)
    assert bool(torch.isnan(got[:, 7:9]).all())
    assert torch.equal(got[:, 9:], want[:, 9:]) and torch.equal(got[:, :7], want[:, :7])
    assert gather.gather_cols.launches == before


@pytest.mark.parametrize("probe", grid_cost.PROBES, ids=lambda p: p.fn.__name__)
def test_grid_probe_matches_plain(cuda_device, probe):
    """At T = 1, 7, 16, 2,500 and 2,501 (K8 at the even T at or above each),
    K10 with zero, positive and negative loop counts: bit-equal into memory
    that held NaN, each launch counted (``chip_smoke.check_probe``)."""
    for args in [probe.args(2500, cuda_device)] + probe.check_args(cuda_device):
        assert check_probe(probe, args) == 0.0
