"""Port HexPlane, deformation network and interop against the JAX package,
with the JAX-initialized weights carried across through ``interop``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_cfg
from fourdgs_tpu.models import deformation as jdeform
from fourdgs_tpu.models import hexplane as jhex
from fourdgs_tpu_torch import interop
from fourdgs_tpu_torch.models import hexplane as thex
from fourdgs_tpu_torch.models.deformation import Deformation
from tests.test_torch_math import warm_cpu_math  # noqa: F401  (autouse)

K_SH = 4  # sh degree 1 of _tiny_cfg


def _jax_deform(cfg, seed=0):
    tree = jdeform.init_deformation(jax.random.key(seed), cfg.hidden, K_SH)
    return jax.tree.map(np.asarray, tree)


def _port_deform(cfg, tree):
    return interop.load_deform_tree(
        Deformation(cfg.hidden, K_SH, device="cpu"), tree)


def _points(n=300, seed=0):
    rng = np.random.default_rng(seed)
    # slightly past the AABB too: exercises the border clamp
    xyz = rng.uniform(-1.1, 1.1, (n, 3)).astype(np.float32)
    aabb = np.array([[1.0, 0.9, 1.0], [-1.0, -1.0, -0.8]], np.float32)
    return rng, xyz, aabb


@pytest.mark.parametrize("t_kind", ["scalar", "per_point"])
def test_query_hexplane(t_kind):
    cfg = _tiny_cfg()
    tree = _jax_deform(cfg)
    planes = {k: v for k, v in tree.items() if k.startswith("grid_")}
    # non-trivial time planes (their init is all ones)
    rng, xyz, aabb = _points()
    planes = {k: (v * rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
              for k, v in planes.items()}
    t = (np.float32(0.37) if t_kind == "scalar"
         else rng.uniform(0, 1, (xyz.shape[0],)).astype(np.float32))
    want = np.asarray(jhex.query_hexplane(
        {k: jnp.asarray(v) for k, v in planes.items()}, jnp.asarray(aabb),
        jnp.asarray(xyz), jnp.asarray(t), 2))
    got = thex.query_hexplane(
        {k: torch.from_numpy(v) for k, v in planes.items()},
        torch.from_numpy(aabb), torch.from_numpy(xyz), torch.tensor(t), 2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


FLAG_SETS = {
    # dnerf/hypernerf presets: the defaults
    "defaults": {},
    # dynerf and multipleview presets
    "all_heads": dict(no_do=False, no_dshs=False, no_ds=False),
    "apply_rotation": dict(no_do=False, apply_rotation=True),
}


@pytest.mark.parametrize("flags", sorted(FLAG_SETS))
def test_deform(flags):
    cfg = _tiny_cfg()
    for k, v in FLAG_SETS[flags].items():
        setattr(cfg.hidden, k, v)
    tree = _jax_deform(cfg, seed=1)
    rng, xyz, aabb = _points(seed=1)
    n = xyz.shape[0]
    scales = rng.normal(-3, 0.5, (n, 3)).astype(np.float32)
    rots = rng.normal(size=(n, 4)).astype(np.float32)
    op = rng.normal(size=(n, 1)).astype(np.float32)
    shs = rng.normal(size=(n, K_SH, 3)).astype(np.float32)
    t = np.float32(0.61)
    want = jdeform.deform(jax.tree.map(jnp.asarray, tree), cfg.hidden,
                          jnp.asarray(aabb), xyz, scales, rots, op, shs,
                          jnp.asarray(t))
    mod = _port_deform(cfg, tree)
    with torch.no_grad():
        got = mod(*map(torch.from_numpy, (aabb, xyz, scales, rots, op, shs)),
                  torch.tensor(t))
    for name, g, w in zip(("xyz", "scales", "rot", "op", "shs"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   err_msg=name)


def test_interop_round_trip_and_layout():
    cfg = _tiny_cfg()
    tree = _jax_deform(cfg, seed=2)
    mod = _port_deform(cfg, tree)
    # port layout: nn.Linear weight [out, in] is the JAX [in, out] transposed
    w_jax = tree["head_pos"][1]["w"]
    np.testing.assert_array_equal(mod.heads["pos"][1].weight.detach().numpy(),
                                  w_jax.T)
    back = interop.deform_to_tree(mod)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    # our flatten order is jax.tree.flatten's
    for a, b in zip(interop.flatten_tree(tree), jax.tree.leaves(tree)):
        assert a is b
    with pytest.raises(ValueError):
        bad = dict(tree)
        bad["head_pos"] = [tree["head_pos"][0], {"w": w_jax.T, "b": tree["head_pos"][1]["b"]}]
        interop.load_deform_tree(Deformation(cfg.hidden, K_SH, device="cpu"), bad)


def test_lego_leaf_order_matches_jax():
    from fourdgs_tpu.configs.core import load_config as jload
    from fourdgs_tpu_torch.configs.core import load_config as tload

    preset = "fourdgs_tpu/configs/presets/dnerf/lego.py"
    jcfg, tcfg = jload(preset), tload(preset)
    jtree = jdeform.init_deformation(jax.random.key(0), jcfg.hidden, 16)
    jleaves = jax.tree.leaves(jtree)
    mod = Deformation(tcfg.hidden, 16, device="cpu")
    tleaves = interop.flatten_tree(interop.deform_to_tree(mod))
    assert len(tleaves) == len(jleaves) == 38
    assert [x.shape for x in tleaves] == [x.shape for x in jleaves]
    assert sum(x.size * 4 for x in tleaves) == pytest.approx(9.8e6, rel=0.02)


def test_init_distributions():
    cfg = _tiny_cfg()
    cfg.hidden.zero_init_heads = True
    mod = Deformation(cfg.hidden, K_SH, seed=3, device="cpu")
    for h in mod.heads.values():
        assert not h[1].weight.any() and not h[1].bias.any()
        assert h[0].weight.abs().max() > 0
    lin = mod.feature_out[0]
    fan_in, fan_out = lin.in_features, lin.out_features
    assert lin.weight.abs().max() <= (6.0 / (fan_in + fan_out)) ** 0.5
    assert lin.bias.abs().max() <= fan_in ** -0.5
    for k, p in mod.grids.items():
        plane = int(k.split("_p")[1])
        if plane in thex.TEMPORAL_PLANES:
            assert torch.all(p == 1.0)
        else:
            assert 0.1 <= p.min() and p.max() <= 0.5
    # same seed, same weights
    again = Deformation(cfg.hidden, K_SH, seed=3, device="cpu")
    for a, b in zip(mod.parameters(), again.parameters()):
        assert torch.equal(a, b)
    assert dataclasses.asdict(mod.hidden) == dataclasses.asdict(cfg.hidden)
