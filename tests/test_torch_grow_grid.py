"""``models/densify.py::grow`` and ``models/grid.py`` of the port against
the JAX package's.

- ``grow`` (the ``--add_point`` growth) from one JAX state carried across
  (``tests/test_torch_densify.py``'s helpers), with JAX's normal draws
  given to the port: alive, table, counts and slots exactly, parameters
  within rtol 1e-6, the moments zeroed at the same slots; with room and
  with fewer free slots than candidates; and JAX's own case
  (``tests/test_aux.py:230``) on the port;
- ``sample_dense_grid`` on a random grid at points inside and outside the
  AABB, and with a degenerate axis, against JAX's to 1e-6; JAX's own case
  (``tests/test_aux.py:214``) on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs_tpu.models import densify as jdens
from fourdgs_tpu.models import grid as jgrid
from fourdgs_tpu_torch.models import densify as tdens
from fourdgs_tpu_torch.models import gaussians as TG
from fourdgs_tpu_torch.models import grid as tgrid
from tests.test_torch_densify import CAP, _assert_same, _carry, _jax_state


@pytest.mark.parametrize("n_alive,threshold", [(60, 0.3), (240, 0.1)])
def test_grow_matches_jax(n_alive, threshold):
    js, jm = _jax_state(n_alive, seed=4)
    aabb = jnp.asarray([[1.4, 1.4, 1.4], [-1.4, -1.4, -1.4]], jnp.float32)
    js = js._replace(aabb=aabb)
    ts, tm = _carry(js, jm)
    key = jax.random.key(7)
    normals = np.array(jax.random.normal(key, (CAP, 3)))   # JAX's draws
    js1, jm1, jn = jdens.grow(key, js, jm, density_threshold=threshold,
                              displacement_scale=0.2)
    ts1, tm1, tn = tdens.grow(ts, tm, threshold, 0.2, normals=torch.from_numpy(normals))
    assert tn == int(jn) > 0
    _assert_same(ts1, tm1, js1, jm1, "grow")
    if n_alive == 240:   # more candidates than the 16 free slots
        assert tn == CAP - n_alive


def test_grow_jax_case_on_port():
    """``tests/test_aux.py::TestGrow``: 8 points 100 apart all qualify and
    double the live count."""
    js, jm = _jax_state(8, seed=1)
    ts, tm = _carry(js, jm)
    live = torch.nonzero(ts.alive).squeeze(1)
    params = dict(ts.params)
    xyz = params["xyz"].clone()
    xyz[live] = torch.arange(8, dtype=torch.float32)[:, None] * torch.tensor([[100.0, 0, 0]])
    params["xyz"] = xyz
    ts = ts._replace(params=params, aabb=torch.tensor([[1e6] * 3, [-1e6] * 3]))
    ts2, _, n_new = tdens.grow(ts, tm, 5.0, 5.0,
                               generator=torch.Generator().manual_seed(0))
    assert n_new == 8 and int(TG.count_alive(ts2)) == 16
    with pytest.raises(ValueError, match="generator or the normals"):
        tdens.grow(ts, tm)


@pytest.mark.parametrize("shape,flat_axis", [((4, 5, 6, 2), None), ((3, 4, 2, 1), 2)])
def test_sample_dense_grid_matches_jax(shape, flat_axis):
    rng = np.random.default_rng(sum(shape))
    grid = rng.normal(size=shape).astype(np.float32)
    aabb = np.array([[1.0, 2.0, 0.5], [-1.0, -0.5, -0.5]], np.float32)
    if flat_axis is not None:
        aabb[:, flat_axis] = 0.25                   # span 0: the guarded divide
    xyz = rng.uniform(-1.5, 2.5, (200, 3)).astype(np.float32)   # some outside
    xyz[:3] = aabb[0]
    xyz[3:6] = aabb[1]
    want = np.asarray(jgrid.sample_dense_grid(jnp.asarray(grid), jnp.asarray(aabb),
                                              jnp.asarray(xyz)))
    got = tgrid.sample_dense_grid(torch.from_numpy(grid), torch.from_numpy(aabb),
                                  torch.from_numpy(xyz)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert got.shape == (200, shape[3])


def test_dense_grid_jax_case_on_port():
    """``tests/test_aux.py::TestDenseGrid``: a ramp along x, sampled halfway
    and at a corner."""
    grid = tgrid.init_dense_grid(1, (4, 4, 4), device="cpu")
    assert grid.shape == (4, 4, 4, 1) and not grid.any()
    assert tuple(np.asarray(jgrid.init_dense_grid(jax.random.key(0), 1, (4, 4, 4))).shape) == (
        4, 4, 4, 1)
    grid[..., 0] = torch.arange(4, dtype=torch.float32)[:, None, None]
    aabb = torch.tensor([[1.0, 1.0, 1.0], [-1.0, -1.0, -1.0]])
    out = tgrid.sample_dense_grid(grid, aabb, torch.tensor([[0.0, 0.0, 0.0]]))
    np.testing.assert_allclose(out.numpy(), [[1.5]], atol=1e-6)
    out = tgrid.sample_dense_grid(grid, aabb, torch.tensor([[-1.0, 0.0, 0.0]]))
    np.testing.assert_allclose(out.numpy(), [[0.0]], atol=1e-6)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tgrid.init_dense_grid()
