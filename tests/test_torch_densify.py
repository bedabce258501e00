"""Point-cloud initialisation and maintenance of the port against the JAX
package's: ``ops/knn.py::mean_sq_dist_3nn``, ``models/gaussians.py``
(``create_from_pcd``, ``grow_capacity``, ``one_up_sh_degree``) and
``models/densify.py`` (the free list, clone, split with JAX's normals
injected, prune with the size gate on and off, the opacity reset).

Each maintenance case starts from one JAX state carried across
(``interop.state_from_jax``) with random statistics, shapes and Adam
moments; the "full" case has fewer free slots than clone and split want, so
both drop writes as JAX does. Alive, table, counts and slots must match
exactly, parameters within rtol 1e-6, and the moments must be zeroed at the
same slots (they are copied, never computed: exactly equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs_tpu.configs.core import load_config as jload_config
from fourdgs_tpu.models import densify as jdens
from fourdgs_tpu.models import gaussians as JG
from fourdgs_tpu.ops.knn import mean_sq_dist_3nn as jknn
from fourdgs_tpu.train import adam as jadam
from fourdgs_tpu_torch import interop
from fourdgs_tpu_torch.configs.core import load_config
from fourdgs_tpu_torch.models import densify as tdens
from fourdgs_tpu_torch.models import gaussians as TG
from fourdgs_tpu_torch.ops.knn import mean_sq_dist_3nn as tknn
from fourdgs_tpu_torch.train import adam as tadam

EXTENT = 3.0
PD = 0.01


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cloud(n, seed=0, duplicates=True):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.3, 1.3, (n, 3)).astype(np.float32)
    if duplicates:
        pts[[10, 20, n - 1]] = pts[3]      # a point with three twins
        pts[11] = pts[12]
    return pts, rng.uniform(0, 1, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("n", [300, 2049])
def test_knn_matches_jax(n):
    """2,049 points cross the 2,048-query chunk boundary."""
    pts, _ = _cloud(n)
    want = np.asarray(jknn(jnp.asarray(pts)))
    got = tknn(torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert got[3] == got[10] and got[3] > 0    # three zeros and the next


def _cfgs(capacity, capacity_init, sh_degree=1):
    out = []
    for load in (jload_config, load_config):
        cfg = load()
        cfg.tpu.capacity = capacity
        cfg.tpu.capacity_init = capacity_init
        cfg.model.sh_degree = sh_degree
        cfg.hidden.net_width = 16
        cfg.hidden.multires = (1,)
        out.append(cfg)
    return out


@pytest.mark.parametrize("n,capacity,capacity_init", [
    (300, 400_000, 0),     # the auto rule: 16,384 rows
    (300, 1000, 320),
    (2049, 10_000, 0),     # the auto rule capped at the capacity
])
def test_create_from_pcd_matches_jax(n, capacity, capacity_init):
    jcfg, tcfg = _cfgs(capacity, capacity_init)
    pts, cols = _cloud(n)
    js = JG.create_from_pcd(jax.random.key(0), jcfg, pts, cols, 2.5)
    ts = TG.create_from_pcd(tcfg, pts, cols, 2.5, seed=0, device="cpu")
    got = interop.state_to_numpy(ts)
    cap = js.alive.shape[0]
    assert ts.alive.shape[0] == cap == TG.initial_capacity(tcfg, n)
    for k in TG.PRIMITIVE_KEYS:
        w = np.asarray(js.params[k])
        if k == "scaling":    # log(sqrt(mean 3-NN distance))
            np.testing.assert_allclose(got.params[k], w, rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(got.params[k], w, err_msg=k)
    for k in ("alive", "deformation_table", "aabb", "max_radii2d",
              "xyz_gradient_accum", "denom", "deformation_accum"):
        np.testing.assert_array_equal(getattr(got, k), np.asarray(getattr(js, k)),
                                      err_msg=k)
    assert got.active_sh_degree == int(js.active_sh_degree) == 0
    assert got.spatial_lr_scale == js.spatial_lr_scale == 2.5
    assert (jax.tree.map(np.shape, got.params["deform"])
            == jax.tree.map(np.shape, _np(js.params["deform"])))


def test_create_from_pcd_rejects_a_cloud_above_capacity():
    jcfg, tcfg = _cfgs(100, 0)
    pts, cols = _cloud(300)
    with pytest.raises(ValueError, match="exceeds capacity"):
        JG.create_from_pcd(jax.random.key(0), jcfg, pts, cols, 1.0)
    with pytest.raises(ValueError, match="exceeds capacity"):
        TG.create_from_pcd(tcfg, pts, cols, 1.0, device="cpu")


CAP = 256


def _jax_state(n_alive, seed=0):
    """A JAX state of capacity 256 with ``n_alive`` scattered live slots,
    random shapes (a third of them above the split size), opacities,
    rotations, statistics and table, and random Adam moments."""
    jcfg, _ = _cfgs(CAP, CAP)
    rng = np.random.default_rng(seed)
    pts, cols = _cloud(CAP, seed, duplicates=False)
    js = JG.create_from_pcd(jax.random.key(seed), jcfg, pts, cols, 1.0)
    alive = np.zeros(CAP, bool)
    alive[rng.permutation(CAP)[:n_alive]] = True
    p = _np(js.params)
    p["scaling"] = np.log(rng.uniform(0.005, 0.03, (CAP, 3)) * np.where(
        rng.uniform(size=(CAP, 1)) < 0.35, 20.0, 1.0)).astype(np.float32)
    p["scaling"][~alive] = -10.0
    p["opacity"] = rng.normal(-1.0, 2.5, (CAP, 1)).astype(np.float32)
    p["rotation"] = rng.normal(size=(CAP, 4)).astype(np.float32)
    p["f_rest"] = rng.normal(size=p["f_rest"].shape).astype(np.float32)
    denom = rng.integers(0, 4, CAP).astype(np.float32)
    js = js._replace(
        params=jax.tree.map(jnp.asarray, p),
        alive=jnp.asarray(alive),
        deformation_table=jnp.asarray(alive & (rng.uniform(size=CAP) < 0.8)),
        denom=jnp.asarray(denom),
        xyz_gradient_accum=jnp.asarray(
            (denom * rng.exponential(2e-4, CAP)).astype(np.float32)),
        max_radii2d=jnp.asarray(rng.integers(0, 40, CAP).astype(np.float32)),
        deformation_accum=jnp.asarray(rng.uniform(size=(CAP, 3)).astype(np.float32)),
    )
    moments = tuple(jax.tree.map(
        lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)), p)
        for _ in range(2))
    return js, moments


def _carry(js, moments):
    _, tcfg = _cfgs(CAP, CAP)
    ts = interop.state_from_jax(_np(js), tcfg, device="cpu")
    ta = interop.adam_from_jax_numpy(_np(moments[0]), _np(moments[1]), 3, ts.params)
    return ts, (ta.mu, ta.nu)


def _assert_same(ts, tmoments, js, jmoments, what):
    got = interop.state_to_numpy(ts)
    for k in ("alive", "deformation_table", "max_radii2d", "xyz_gradient_accum",
              "denom", "deformation_accum"):
        np.testing.assert_array_equal(getattr(got, k), np.asarray(getattr(js, k)),
                                      err_msg=f"{what}: {k}")
    for k in TG.PRIMITIVE_KEYS:
        np.testing.assert_allclose(got.params[k], np.asarray(js.params[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=f"{what}: {k}")
    mu, nu, _ = interop.adam_to_numpy(
        tadam.AdamState(mu=tmoments[0], nu=tmoments[1], count=3))
    for g_tree, w_tree in ((mu, jmoments[0]), (nu, jmoments[1])):
        for g, w in zip(jax.tree.leaves(g_tree), jax.tree.leaves(_np(w_tree))):
            np.testing.assert_array_equal(g, w, err_msg=f"{what}: moments")


# live slots: plenty of room, and fewer free slots than clone + split want
ROOMS = {"roomy": 120, "full": 246}


@pytest.mark.parametrize("room", sorted(ROOMS))
def test_free_list_matches_jax(room):
    js, _ = _jax_state(ROOMS[room])
    free, n_free = jdens._free_list(js.alive)
    got = tdens._free_list(torch.tensor(np.asarray(js.alive)))
    assert got.shape[0] == int(n_free) == CAP - ROOMS[room]
    np.testing.assert_array_equal(got.numpy(), np.asarray(free)[:int(n_free)])


@pytest.mark.parametrize("room", sorted(ROOMS))
def test_clone_and_split_match_jax(room):
    """Clone, then split from the same gradients, each against JAX's; the
    threshold puts about half the live Gaussians above it. With room, the
    split runs on the cloned state (as the loop's densify does); when full,
    the clone takes every free slot, so the split runs on the state before
    it and places only some children."""
    js, jm = _jax_state(ROOMS[room])
    ts, tm = _carry(js, jm)
    grads_j = jdens.compute_grads(js)
    grads_t = tdens.compute_grads(ts)
    np.testing.assert_array_equal(grads_t.numpy(), np.asarray(grads_j))
    thr = float(np.median(np.asarray(grads_j)[np.asarray(js.alive)]))
    ext = jnp.float32(EXTENT)        # the loop's traced float32 scalar

    js1, jm1, jn = jdens.densify_and_clone(js, jm, grads_j, jnp.float32(thr), ext, PD)
    ts1, tm1, tn = tdens.densify_and_clone(ts, tm, grads_t, thr, EXTENT, PD)
    assert tn == int(jn) > 0
    _assert_same(ts1, tm1, js1, jm1, "clone")

    key = jax.random.key(7)
    normals = torch.stack([torch.tensor(np.asarray(
        jax.random.normal(jax.random.fold_in(key, j), (CAP, 3)))) for j in range(2)])
    if room == "full":
        assert int(js1.alive.sum()) == CAP
        js1, jm1, ts1, tm1 = js, jm, ts, tm
    js2, jm2, jn2 = jdens.densify_and_split(key, js1, jm1, grads_j, jnp.float32(thr),
                                            ext, PD)
    ts2, tm2, tn2 = tdens.densify_and_split(ts1, tm1, grads_t, thr, EXTENT, PD, normals)
    assert tn2 == int(jn2) > 0
    _assert_same(ts2, tm2, js2, jm2, "split")
    n_free = CAP - int(js1.alive.sum())
    n_sel = int(((np.asarray(grads_j) >= thr) & np.asarray(js1.alive)
                 & (np.exp(np.asarray(js1.params["scaling"])).max(1) > PD * EXTENT)).sum())
    if room == "full":   # supply short: writes dropped, some parents kept
        assert 2 * n_sel > n_free and tn2 < 2 * n_sel
    else:
        assert tn2 == 2 * n_sel


def test_split_rejects_misshapen_normals():
    js, jm = _jax_state(ROOMS["roomy"])
    ts, tm = _carry(js, jm)
    with pytest.raises(ValueError, match="normals"):
        tdens.densify_and_split(ts, tm, tdens.compute_grads(ts), 0.0, EXTENT, PD,
                                torch.zeros(2, CAP - 1, 3))


@pytest.mark.parametrize("size_on", [False, True])
def test_prune_matches_jax(size_on):
    js, jm = _jax_state(ROOMS["roomy"])
    ts, _ = _carry(js, jm)
    jp, jn = jdens.prune(js, jnp.float32(0.2), jnp.float32(EXTENT), size_on)
    tp, tn = tdens.prune(ts, 0.2, EXTENT, size_on)
    assert int(tn) == int(jn) > 0
    np.testing.assert_array_equal(tp.alive.numpy(), np.asarray(jp.alive))
    if size_on:   # the size criteria add to the opacity criterion
        assert int(tn) > int(tdens.prune(ts, 0.2, EXTENT, False)[1])


def test_reset_opacity_matches_jax():
    js, jm = _jax_state(ROOMS["roomy"])
    ts, tm = _carry(js, jm)
    js1, jm1 = jdens.reset_opacity(js, jm)
    ts1, tm1 = tdens.reset_opacity(ts, tm)
    _assert_same(ts1, tm1, js1, jm1, "reset")
    assert float(torch.sigmoid(ts1.params["opacity"]).max()) <= 0.01 + 1e-8


def test_grow_capacity_and_sh_degree_match_jax():
    js, jm = _jax_state(ROOMS["full"])
    ts, tm = _carry(js, jm)
    ja = jadam.AdamState(mu=jm[0], nu=jm[1], count=jnp.int32(3))
    js2, ja2 = JG.grow_capacity(js, ja, 512)
    ts2, ta2 = TG.grow_capacity(ts, tadam.AdamState(mu=tm[0], nu=tm[1], count=3), 512)
    assert ts2.alive.shape[0] == js2.alive.shape[0] == 512
    _assert_same(ts2, (ta2.mu, ta2.nu), js2, (ja2.mu, ja2.nu), "grow")
    assert ts2.params["deform"] is ts.params["deform"]
    assert ta2.mu["deform"] is tm[0]["deform"]
    assert TG.grow_capacity(ts2, ta2, 512)[0] is ts2     # not larger: unchanged
    for _ in range(3):
        js2 = JG.one_up_sh_degree(js2, 2)
        ts2 = TG.one_up_sh_degree(ts2, 2)
        assert ts2.active_sh_degree == int(js2.active_sh_degree)
    assert ts2.active_sh_degree == 2
