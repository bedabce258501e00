"""The CUDA blend kernel against its plain PyTorch version, on the card.

Skips without CUDA. It imports no JAX, so it runs where only PyTorch is
installed; the repository's conftest imports JAX, hence on such a machine:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from chip_smoke import compare_blend, synthetic_blend_inputs
from fourdgs_tpu_torch.ops import blend

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the blend kernel has no CPU mode")
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
