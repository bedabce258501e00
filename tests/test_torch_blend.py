"""The blend kernel's plain PyTorch version against the JAX kernel's
specification: the independent NumPy simulation ``kernel_sim_forward`` and
the Pallas kernel under the interpreter. Plus the wrapper's CPU dispatch and
input checks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs_tpu.ops import pallas_blend as PB
from fourdgs_tpu_torch.ops import blend
from tests.test_math_core import look_at_camera
from tests.test_pallas_raster import _bin_scene, kernel_sim_forward
from tests.test_tiled_raster import random_scene
from tests.test_torch_math import warm_cpu_math  # noqa: F401  (autouse)


def _straddle_inputs(seed=7):
    # test_pallas_raster.py::test_forward_matches_sim_boundary_straddle
    rng = np.random.default_rng(seed)
    T, gx, K = 6, 3, 1024
    lens = [37, 129, 0, 200, 95, 61]
    starts = np.cumsum([0] + lens[:-1]).astype(np.int32)
    stops = (starts + np.array(lens)).astype(np.int32)
    feat = np.zeros((PB.FEAT_ROWS, K), np.float32)
    feat[0] = rng.uniform(0, 48, K)
    feat[1] = rng.uniform(0, 32, K)
    feat[2] = rng.uniform(0.01, 0.3, K)
    feat[3] = rng.uniform(-0.05, 0.05, K)
    feat[4] = rng.uniform(0.01, 0.3, K)
    feat[5] = rng.uniform(0.002, 0.9, K)
    feat[6:10] = rng.uniform(0, 1, (4, K))
    return feat, starts, stops, gx, T, K


def _saturated_inputs():
    # test_pallas_raster.py::test_forward_matches_sim_saturated
    w = h = 64
    cam = look_at_camera([0, 0, -4], [0, 0, 0], width=w, height=h)
    p = random_scene(128, seed=5, spread=0.3)
    p["opacities"] = jnp.full((128,), 0.9)
    K = 4096
    feat, starts, stops = _bin_scene(p, cam, w, h, K, (4, 4))
    return feat, starts, stops, 4, 16, K


def _plain(feat, starts, stops, gx, row_off=(0, 1), bg=(0.0, 0.0, 0.0)):
    feat = np.ascontiguousarray(feat)   # _bin_scene returns a transposed view
    return blend.blend_forward(
        torch.tensor(feat), torch.tensor(starts), torch.tensor(stops),
        torch.tensor(row_off, dtype=torch.int32),
        torch.tensor(bg, dtype=torch.float32), gx).numpy()


@pytest.mark.parametrize("case", ["straddle", "saturated"])
def test_plain_matches_kernel_sim(case):
    feat, starts, stops, gx, T, K = (
        _straddle_inputs() if case == "straddle" else _saturated_inputs())
    got = _plain(feat, starts, stops, gx)
    sim = kernel_sim_forward(feat, starts, stops, gx, T)
    assert got.shape == (T, 5, 256)
    np.testing.assert_allclose(got.transpose(0, 2, 1), sim[:, :, 0:5], atol=1e-5)
    if case == "saturated":
        # rule 3: T never falls below T_STOP, and some pixel rides it
        t_fin = got[:, 4]
        assert t_fin.min() >= 1e-4 and (t_fin < 1e-3).any()


@pytest.mark.parametrize("row_off", [(0, 1), (1, 2)])
def test_plain_matches_pallas_interpret(row_off):
    feat, starts, stops, gx, T, K = _straddle_inputs(seed=3)
    # tiles at start == K (budget saturation) and a heavy tile
    starts = np.concatenate([starts, [K, K]]).astype(np.int32)
    stops = np.concatenate([stops, [K, K]]).astype(np.int32)
    stops[-3] = K
    T = starts.shape[0]
    bg = (0.2, 0.5, 0.9)
    want = np.asarray(PB.blend_pallas(
        jnp.asarray(feat), jnp.asarray(starts), jnp.asarray(stops),
        jnp.asarray(row_off, np.int32), jnp.asarray(bg, np.float32),
        gx, T, K, True))
    got = _plain(feat, starts, stops, gx, row_off, bg)
    # split2 scan accuracy budget of the Pallas kernel (test_pallas_raster.py:244-251)
    np.testing.assert_allclose(got, want, atol=5e-4)


def test_wrapper_checks_and_cpu_dispatch():
    feat, starts, stops, gx, T, K = _straddle_inputs()
    before = blend.blend_forward.launches
    args = [torch.from_numpy(feat), torch.from_numpy(starts),
            torch.from_numpy(stops), torch.tensor([0, 1], dtype=torch.int32),
            torch.zeros(3)]
    out = blend.blend_forward(*args, gx)
    # the plain version ran: no kernel launch counted
    assert blend.blend_forward.launches == before
    assert torch.equal(out, blend.blend_forward_plain(*args, gx))
    bad = [
        (0, args[0].double()),
        (0, args[0][:10]),
        (0, args[0][:, :1020]),
        (1, args[1].long()),
        (2, args[2][:-1]),
        (3, torch.tensor([0, 1, 2], dtype=torch.int32)),
        (4, torch.zeros(3, dtype=torch.float64)),
        (0, args[0].T.contiguous().T),
    ]
    for i, x in bad:
        a = list(args)
        a[i] = x
        with pytest.raises(ValueError):
            blend.blend_forward(*a, gx)
