"""Training checkpoints of the port (``train/checkpoint.py``).

- save then load is exact: every parameter, Adam moment, statistic, the
  alive mask, the AABB, the SH degree, the iteration;
- a state saved by JAX's ``save_checkpoint`` (orbax) and restored with orbax
  equals the port's checkpoint of the same state, after ``interop``'s
  conversion, leaf for leaf;
- ``find_stage_checkpoint`` picks the latest of a stage;
- a config that builds another deformation is refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_cfg
from fourdgs_tpu.models.gaussians import GaussianState as JGaussianState
from fourdgs_tpu.train import adam as jadam
from fourdgs_tpu.train import checkpoint as jckpt
from fourdgs_tpu_torch import interop
from fourdgs_tpu_torch.models import gaussians as G
from fourdgs_tpu_torch.train import adam as tadam
from fourdgs_tpu_torch.train import checkpoint as tckpt
from tests.test_torch_cli import one_torch_thread  # noqa: F401  (autouse)


def _state(cfg, seed=0):
    """A port state with every field off its initial value."""
    rng = np.random.default_rng(seed)
    n = 300
    state = G.create_from_pcd(cfg, rng.uniform(-1, 1, (n, 3)), rng.uniform(0, 1, (n, 3)),
                              2.5, seed=seed, device="cpu")
    P = state.alive.shape[0]

    def r(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    alive = state.alive.clone()
    alive[::7] = False
    state = state._replace(alive=alive, max_radii2d=r(P).abs(),
                           xyz_gradient_accum=r(P).abs(), denom=r(P).abs().round(),
                           deformation_accum=r(P, 3), deformation_table=alive.clone(),
                           active_sh_degree=1, spatial_lr_scale=2.5)
    opt = tadam.init(state.params)
    for tree in (opt.mu, opt.nu):
        for k in G.PRIMITIVE_KEYS:
            tree[k].copy_(r(*tree[k].shape))
        for v in tree["deform"].values():
            v.copy_(r(*v.shape))
    return state, opt._replace(count=17)


def _leaves(state, opt):
    """(name, numpy) of every leaf in the JAX layout."""
    s = interop.state_to_numpy(state)
    mu, nu, count = interop.adam_to_numpy(opt)
    tree = {"state": s._asdict(), "adam": {"mu": mu, "nu": nu, "count": count}}
    return [(jax.tree_util.keystr(p), np.asarray(x))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_save_load_is_exact(tmp_path):
    cfg = _tiny_cfg()
    state, opt = _state(cfg)
    path = tckpt.save_checkpoint(str(tmp_path), state, opt, 42, "fine")
    assert path.endswith("chkpnt_fine_42")
    got_state, got_opt, it = tckpt.load_checkpoint(path, cfg, device="cpu")
    assert it == 42 and got_opt.count == 17
    assert got_state.active_sh_degree == 1 and got_state.spatial_lr_scale == 2.5
    want, got = _leaves(state, opt), _leaves(got_state, got_opt)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    # the restored state trains: the moments are the step's own tensors
    assert got_opt.mu["xyz"].shape == got_state.params["xyz"].shape


def test_matches_jax_orbax_checkpoint(tmp_path):
    cfg = _tiny_cfg()
    state, opt = _state(cfg, seed=1)
    s = interop.state_to_numpy(state)
    mu, nu, count = interop.adam_to_numpy(opt)
    jstate = JGaussianState(**{**jax.tree.map(jnp.asarray, s._asdict()),
                               "active_sh_degree": jnp.int32(s.active_sh_degree),
                               "spatial_lr_scale": s.spatial_lr_scale})
    jopt = jadam.AdamState(mu=jax.tree.map(jnp.asarray, mu),
                           nu=jax.tree.map(jnp.asarray, nu), count=jnp.int32(count))
    jpath = jckpt.save_checkpoint(str(tmp_path / "jax"), jstate, jopt, 9, "coarse")
    js, ja, jit = jckpt.load_checkpoint(jpath)
    tpath = tckpt.save_checkpoint(str(tmp_path / "port"), state, opt, 9, "coarse")
    ts, ta, tit = tckpt.load_checkpoint(tpath, cfg, device="cpu")
    assert tit == jit == 9
    assert ts.active_sh_degree == int(js.active_sh_degree)
    assert ts.spatial_lr_scale == js.spatial_lr_scale
    want = {"state": {**js._asdict(), "active_sh_degree": 0, "spatial_lr_scale": 0},
            "adam": ja._asdict()}
    got_s = interop.state_to_numpy(ts)._asdict()
    got_mu, got_nu, got_count = interop.adam_to_numpy(ta)
    got = {"state": {**got_s, "active_sh_degree": 0, "spatial_lr_scale": 0},
           "adam": {"mu": got_mu, "nu": got_nu, "count": got_count}}
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=jax.tree_util.keystr(path))


def test_find_stage_checkpoint(tmp_path):
    assert tckpt.find_stage_checkpoint(str(tmp_path / "none"), "fine") is None
    for name in ("chkpnt_fine_7", "chkpnt_fine_30", "chkpnt_fine_x", "chkpnt_coarse_99"):
        (tmp_path / name).mkdir()
    for stage, want in (("fine", "chkpnt_fine_30"), ("coarse", "chkpnt_coarse_99")):
        got = tckpt.find_stage_checkpoint(str(tmp_path), stage)
        assert got == jckpt.find_stage_checkpoint(str(tmp_path), stage)
        assert got.endswith(want)


def test_load_refuses_another_deformation(tmp_path):
    cfg = _tiny_cfg()
    state, opt = _state(cfg)
    path = tckpt.save_checkpoint(str(tmp_path), state, opt, 1, "fine")
    cfg.hidden.defor_depth = 2
    with pytest.raises(ValueError, match="deformation parameters"):
        tckpt.load_checkpoint(path, cfg, device="cpu")
