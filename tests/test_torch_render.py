"""The whole slice: ``fourdgs_tpu_torch.render.render`` against
``fourdgs_tpu.render.render(..., backend="pallas")`` (the Pallas interpreter
on the CPU) on the ``_tiny_cfg`` scene, and snapshots across the packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _camera, _tiny_cfg, _tiny_scene
from fourdgs_tpu import render as JR
from fourdgs_tpu.models.gaussians import inverse_sigmoid
from fourdgs_tpu.train import checkpoint as jckpt
from fourdgs_tpu_torch import interop
from fourdgs_tpu_torch import render as TR
from fourdgs_tpu_torch.configs.core import load_config as tload
from fourdgs_tpu_torch.train import checkpoint as tckpt
from tests.test_torch_math import warm_cpu_math  # noqa: F401  (autouse)

SIZE = 64
BG = (0.15, 0.25, 0.35)


def _scene(seed=0):
    cfg = _tiny_cfg()
    state = _tiny_scene(cfg, seed=seed)
    params = dict(state.params)
    # scale the opacities by 0.1 (test_pallas_raster.py:397): transmittance
    # stays clear of T_STOP, the exact-match regime
    params["opacity"] = inverse_sigmoid(0.1 * jax.nn.sigmoid(params["opacity"]))
    return cfg, state._replace(params=params)


def _jax_render(cfg, state, stage, time=0.3):
    cam = JR.CameraArrays.from_camera(_camera(time=time, size=SIZE))
    return JR.render(state.params, state, cam, cfg, SIZE, SIZE, stage,
                     jnp.asarray(BG), active_sh_degree=1, backend="pallas")


@torch.no_grad()   # a serving caller: render is differentiable
def _port_render(cfg, tstate, stage, time=0.3):
    cam = TR.CameraArrays.from_camera(_camera(time=time, size=SIZE), device="cpu")
    return TR.render(tstate.params, tstate, cam, cfg, SIZE, SIZE, stage,
                     torch.tensor(BG), active_sh_degree=1, device="cpu")


def _assert_match(t, j):
    np.testing.assert_allclose(t.color.numpy(), np.asarray(j.color), atol=1e-4)
    np.testing.assert_allclose(t.alpha.numpy(), np.asarray(j.alpha), atol=1e-4)
    np.testing.assert_allclose(t.depth.numpy(), np.asarray(j.depth), atol=2e-4)
    np.testing.assert_array_equal(t.radii.numpy(), np.asarray(j.radii))
    assert int(t.num_rendered) == int(j.num_rendered) > 0
    assert int(t.max_tile_len) == int(j.max_tile_len)
    np.testing.assert_allclose(t.dxyz_abs.numpy(), np.asarray(j.dxyz_abs),
                               atol=1e-5)


@pytest.mark.parametrize("stage,time", [("fine", 0.3), ("fine", 0.85),
                                        ("coarse", 0.3)])
def test_render_matches_jax(stage, time):
    cfg, state = _scene()
    j = _jax_render(cfg, state, stage, time)
    params_np = jax.tree.map(np.asarray, state.params)
    tstate = interop.from_jax_numpy(params_np, np.asarray(state.alive),
                                    np.asarray(state.aabb), cfg, device="cpu")
    t = _port_render(cfg, tstate, stage, time)
    assert t.color.shape == (3, SIZE, SIZE)
    _assert_match(t, j)
    if stage == "fine":
        assert float(t.dxyz_abs.max()) > 0   # the deformation moved points


def test_interop_state_round_trip():
    cfg, state = _scene(seed=1)
    params_np = jax.tree.map(np.asarray, state.params)
    tstate = interop.from_jax_numpy(params_np, np.asarray(state.alive),
                                    np.asarray(state.aabb), cfg, device="cpu")
    back, alive, aabb = interop.to_numpy(tstate)
    np.testing.assert_array_equal(alive, np.asarray(state.alive))
    np.testing.assert_array_equal(aabb, np.asarray(state.aabb))
    assert jax.tree.structure(back) == jax.tree.structure(params_np)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params_np)):
        np.testing.assert_array_equal(a, b)


def test_snapshot_across_packages(tmp_path):
    cfg, state = _scene(seed=2)
    # JAX writes, the port reads: the renders agree
    snap = jckpt.save_snapshot(str(tmp_path / "jax"), state, 7)
    tstate = tckpt.load_snapshot(snap, cfg, device="cpu")
    j_loaded = jckpt.load_snapshot(snap, cfg, jax.random.key(0))
    _assert_match(_port_render(cfg, tstate, "fine"),
                  _jax_render(cfg, j_loaded, "fine"))
    # the port writes, the JAX package reads: same leaves, same state
    snap2 = tckpt.save_snapshot(str(tmp_path / "torch"), tstate, 7)
    j_back = jckpt.load_snapshot(snap2, cfg, jax.random.key(0))
    for a, b in zip(jax.tree.leaves(j_back.params), jax.tree.leaves(j_loaded.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(j_back.alive),
                                  np.asarray(j_loaded.alive))
    # and the port's own round trip is exact
    t2 = tckpt.load_snapshot(snap2, cfg, device="cpu")
    a, b = _port_render(cfg, tstate, "fine"), _port_render(cfg, t2, "fine")
    assert torch.equal(a.color, b.color) and torch.equal(a.depth, b.depth)


def test_lego_preset_renders_on_cpu():
    """The lego preset's deformation at full width, on a handful of
    Gaussians and a small image (a CPU-sized run of chip_smoke's path)."""
    cfg = tload("fourdgs_tpu/configs/presets/dnerf/lego.py")
    cfg.tpu.instance_budget = 4096
    from fourdgs_tpu_torch.models import gaussians as G
    from fourdgs_tpu_torch.models.deformation import Deformation

    rng = np.random.default_rng(0)
    n, cap = 200, 256
    prim = G.pad_primitives({
        "xyz": rng.uniform(-1, 1, (n, 3)),
        "f_dc": rng.normal(size=(n, 3)),
        "f_rest": np.zeros((n, 45)),
        "scaling": np.log(rng.uniform(0.02, 0.08, (n, 3))),
        "rotation": rng.normal(size=(n, 4)),
        "opacity": np.full((n, 1), inverse_sigmoid(0.1)),
    }, cap)
    alive = np.arange(cap) < n
    deform = Deformation(cfg.hidden, 16, seed=0, device="cpu")
    aabb = np.array([[1.0] * 3, [-1.0] * 3], np.float32)
    state = G.state_from_numpy(prim, deform, alive, aabb, 3, device="cpu")
    cam = TR.CameraArrays.from_camera(_camera(time=0.5, size=SIZE), device="cpu")
    with torch.no_grad():
        out = TR.render(state.params, state, cam, cfg, SIZE, SIZE, "fine",
                        torch.ones(3), 3, device="cpu")
    assert torch.isfinite(out.color).all()
    assert 0.0 <= float(out.alpha.min()) and float(out.alpha.max()) <= 1.0
    assert float(out.alpha.max()) > 0.05
