"""The evaluation metrics of the port against the JAX package's on random
images: ``utils/losses.py::ssim`` and ``masked_psnr`` against
``fourdgs_tpu.utils.losses``, ``metrics_torch.msssim`` against
``metrics.py::msssim``, each to 1e-5 (float32 convolutions summed in
another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics
import metrics_torch
from fourdgs_tpu.utils import losses as jlosses
from fourdgs_tpu_torch.utils import losses as tlosses
from tests.test_torch_math import warm_cpu_math  # noqa: F401  (autouse)
from tests.test_torch_cli import one_torch_thread  # noqa: F401  (autouse)


def _pair(seed, shape):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    # b correlated with a, so SSIM is far from 0
    b = np.clip(a + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("shape", [(3, 40, 56), (2, 3, 33, 33)])
def test_ssim_matches_jax(shape):
    a, b = _pair(0, shape)
    got = float(tlosses.ssim(torch.from_numpy(a), torch.from_numpy(b)))
    want = float(jlosses.ssim(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert 0.2 < got < 0.99
    assert float(tlosses.ssim(torch.from_numpy(a), torch.from_numpy(a))) == \
        pytest.approx(1.0, abs=1e-5)


@pytest.mark.parametrize("mask_dims", [2, 3])
def test_masked_psnr_matches_jax(mask_dims):
    a, b = _pair(1, (3, 32, 48))
    m = (np.random.default_rng(2).uniform(size=(32, 48)) < 0.3).astype(np.float32)
    if mask_dims == 3:
        m = m[None]
    got = float(tlosses.masked_psnr(*(torch.from_numpy(x) for x in (a, b, m))))
    want = float(jlosses.masked_psnr(*(jnp.asarray(x) for x in (a, b, m))))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    empty = torch.zeros(32, 48)
    assert np.isfinite(float(tlosses.masked_psnr(torch.from_numpy(a),
                                                 torch.from_numpy(b), empty)))


def test_msssim_matches_jax():
    a, b = _pair(3, (1, 3, 100, 100))   # odd sizes at the coarser levels
    got = metrics_torch.msssim(torch.from_numpy(a), torch.from_numpy(b))
    want = metrics.msssim(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert 0.2 < got < 0.99
