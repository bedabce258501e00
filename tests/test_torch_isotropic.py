"""Isotropic Gaussians (the Instant4D mode, ``use_isotropic_gaussian``) and
SH degree 0 in the port, against the JAX package:

- ``models/gaussians.py::get_scaling``: the first scale in all three columns;
- the fine and coarse render against ``fourdgs_tpu.render.render`` (the
  Pallas interpreter), on a scene whose three log-scales differ per
  Gaussian, so the broadcast decides the footprint; and the render at SH
  degree 0 (anisotropic), which the port already ran and which is pinned
  here;
- one fine train step at SH degree 0, isotropic, against JAX's
  ``make_train_step``: the metrics, the Adam moments leaf for leaf (columns
  1–2 of the log-scales get exactly zero gradient on both sides) and the
  densification statistics;
- clone, split (with JAX's normals) and prune with ``isotropic=True``
  against ``fourdgs_tpu.models.densify``.

Tolerances: the render as ``tests/test_torch_render.py`` (colour and alpha
1e-4, depth 2e-4, radii and counts exact); the step as
``tests/test_torch_train.py`` (metrics rtol 1e-5, ``mu`` rtol 4e-3 with
2e-3 of the leaf's scale, ``nu`` 8e-3 / 4e-3); the maintenance as
``tests/test_torch_densify.py`` (masks and counts exact, parameters rtol
1e-6, moments exact)."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _camera, _tiny_cfg, _tiny_scene
from fourdgs_tpu import render as JR
from fourdgs_tpu.models import densify as jdens
from fourdgs_tpu.models import gaussians as JG
from fourdgs_tpu.models.gaussians import inverse_sigmoid
from fourdgs_tpu.train import adam as jadam
from fourdgs_tpu.train import loop as jloop
from fourdgs_tpu_torch import interop
from fourdgs_tpu_torch import render as TR
from fourdgs_tpu_torch.models import densify as tdens
from fourdgs_tpu_torch.models import gaussians as TG
from fourdgs_tpu_torch.train import adam as tadam
from fourdgs_tpu_torch.train import loop as tloop
from tests.test_torch_densify import CAP, EXTENT, PD, ROOMS, _assert_same, _carry, _jax_state
from tests.test_torch_cli import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_math import warm_cpu_math  # noqa: F401  (autouse)
from tests.test_torch_render import _assert_match
from tests.test_torch_train import _camera as _step_camera
from tests.test_torch_train import _leaves_close, _port_state, _t

SIZE = 64
BG = (0.15, 0.25, 0.35)


def test_get_scaling_matches_jax():
    rng = np.random.default_rng(0)
    s = rng.normal(-3.0, 1.0, (40, 3)).astype(np.float32)
    for iso in (False, True):
        got = TG.get_scaling({"scaling": torch.from_numpy(s)}, iso).numpy()
        want = np.asarray(JG.get_scaling({"scaling": jnp.asarray(s)}, iso))
        # torch's and XLA's float32 exp differ by up to an ulp
        np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=0)
        if iso:
            assert (got == got[:, :1]).all() and (want == want[:, :1]).all()
    iso = TG.get_scaling({"scaling": torch.from_numpy(s)}, True)
    assert (iso == iso[:, :1]).all() and not np.allclose(s[:, 1], s[:, 0])
    # only the first column reaches the result
    x = torch.from_numpy(s).requires_grad_()
    (g,) = torch.autograd.grad(TG.get_scaling({"scaling": x}, True).sum(), x)
    assert bool((g[:, 1:] == 0).all()) and bool((g[:, 0] != 0).all())


def _scene(sh_degree, isotropic, seed=0):
    """The ``_tiny_cfg`` scene at ``sh_degree``, opacities ×0.1 (clear of
    T_STOP, as ``test_torch_render.py``), each log-scale column offset by its
    own noise so the isotropic broadcast changes the footprints."""
    cfg = _tiny_cfg()
    cfg.model.sh_degree = sh_degree
    cfg.model.use_isotropic_gaussian = isotropic
    state = _tiny_scene(cfg, seed=seed)
    params = dict(state.params)
    params["opacity"] = inverse_sigmoid(0.1 * jax.nn.sigmoid(params["opacity"]))
    noise = np.random.default_rng(seed + 5).normal(0, 0.4, params["scaling"].shape)
    params["scaling"] = params["scaling"] + jnp.asarray(noise, jnp.float32)
    return cfg, state._replace(params=params)


RENDER_CASES = {
    "iso-fine": (1, True, "fine"),
    "iso-coarse": (1, True, "coarse"),
    "sh0-fine": (0, False, "fine"),
}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_render_matches_jax(case):
    sh, iso, stage = RENDER_CASES[case]
    cfg, state = _scene(sh, iso)
    cam = _camera(time=0.6, size=SIZE)
    j = JR.render(state.params, state, JR.CameraArrays.from_camera(cam), cfg, SIZE,
                  SIZE, stage, jnp.asarray(BG), active_sh_degree=sh, backend="pallas")
    tstate = interop.from_jax_numpy(jax.tree.map(np.asarray, state.params),
                                    np.asarray(state.alive), np.asarray(state.aabb),
                                    cfg, device="cpu")
    with torch.no_grad():
        t = TR.render(tstate.params, tstate, TR.CameraArrays.from_camera(cam, device="cpu"),
                      cfg, SIZE, SIZE, stage, torch.tensor(BG), active_sh_degree=sh,
                      device="cpu")
    _assert_match(t, j)
    if iso:   # the broadcast changed the render: the anisotropic one differs
        cfg.model.use_isotropic_gaussian = False
        with torch.no_grad():
            aniso = TR.render(tstate.params, tstate,
                              TR.CameraArrays.from_camera(cam, device="cpu"), cfg, SIZE,
                              SIZE, stage, torch.tensor(BG), active_sh_degree=sh,
                              device="cpu")
        assert float((aniso.color - t.color).abs().max()) > 1e-2


def test_activated_scales_broadcast_after_the_deformation():
    """The fine stage's scales: the deformation moves all three log-scales,
    then ``exp``, then the first column is repeated (``render.py:113-115``)."""
    cfg, state = _scene(1, True)
    tstate = interop.from_jax_numpy(jax.tree.map(np.asarray, state.params),
                                    np.asarray(state.alive), np.asarray(state.aabb),
                                    cfg, device="cpu")
    cam = TR.CameraArrays.from_camera(_camera(time=0.6, size=SIZE), device="cpu")
    with torch.no_grad():
        aniso = TR.activated_gaussians(tstate.params, tstate, cam, "fine")[1]
        iso = TR.activated_gaussians(tstate.params, tstate, cam, "fine", True)[1]
    torch.testing.assert_close(iso, aniso[:, :1].repeat(1, 3), rtol=0, atol=0)
    assert float((aniso[:, 1] - aniso[:, 0]).abs().max()) > 0


@functools.cache
def _steps():
    """One fine step at SH degree 0, isotropic, batch 2 at 64×64 on a white
    background, in JAX (its program compiled once per process) and in the
    port from the same state."""
    cfg, jstate = _scene(0, True, seed=3)
    cfg.opt.lambda_dssim = 0.0
    cfg.model.white_background = True
    cams = [_step_camera(i, SIZE, SIZE, time=0.2 + 0.5 * i) for i in range(2)]
    jcams = jax.tree.map(lambda *xs: jnp.stack(xs),
                         *[JR.CameraArrays.from_camera(c) for c in cams])
    tcams = TR.CameraArrays(*(_t(np.asarray(x)) for x in jcams))
    img = np.random.default_rng(11).uniform(0, 1, (2, 3, SIZE, SIZE)).astype(np.float32)
    gts = np.round(img * 255.0) / np.float32(255.0)
    jstep = jloop.make_train_step(cfg, SIZE, SIZE, "fine", active_sh_degree=0)
    j1 = jstep(jstate.params, jadam.init(jstate.params), jstate, jcams,
               jnp.asarray(gts), 1)
    tstate = _port_state(jstate, cfg)
    tstep = tloop.make_train_step(cfg, SIZE, SIZE, "fine", 0, device="cpu")
    t1 = tstep(tstate.params, tadam.init(tstate.params), tstate, tcams, _t(gts), 1)
    return j1, t1


def test_train_step_matches_jax():
    (_, ja1, js1, jm1), (_, ta1, ts1, tm1) = _steps()
    for k in ("num_rendered", "max_tile_len", "n_points"):
        assert int(tm1[k]) == int(jm1[k]), k
    for k in ("loss", "l1", "psnr"):
        np.testing.assert_allclose(float(tm1[k]), float(jm1[k]), rtol=1e-5, err_msg=k)
    mu, nu, count = interop.adam_to_numpy(ta1)
    assert count == int(ja1.count) == 1
    jmu, jnu = (jax.tree.map(np.array, t) for t in (ja1.mu, ja1.nu))
    rot_mu = _split_rotation(mu, jmu)
    _split_rotation(nu, jnu)
    _leaves_close(mu, jmu, 4e-3, 2e-3, "mu")
    _leaves_close(nu, jnu, 8e-3, 4e-3, "nu")
    # an isotropic covariance R·s²I·Rᵀ = s²I does not depend on the rotation:
    # its gradient (the quaternions' and the rotation head's) is float32
    # cancellation noise on both sides, under 1e-6 of the positions' moment
    xyz_scale = float(np.abs(np.asarray(ja1.mu["xyz"])).max())
    assert xyz_scale > 0
    for name, got, want in rot_mu:
        assert max(np.abs(got).max(), np.abs(want).max()) <= 1e-6 * xyz_scale, name
    for k in ("max_radii2d", "denom"):
        np.testing.assert_array_equal(getattr(ts1, k).numpy(),
                                      np.asarray(getattr(js1, k)), err_msg=k)
    np.testing.assert_allclose(ts1.xyz_gradient_accum.numpy(),
                               np.asarray(js1.xyz_gradient_accum), rtol=4e-3,
                               atol=2e-3 * float(np.abs(js1.xyz_gradient_accum).max()))


def _split_rotation(got, want):
    """Zero the rotation leaves (``rotation`` and the deformation's
    ``head_rotations``) of two numpy trees in place; return (name, port,
    JAX) of each as they were."""
    out = []
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        name = jax.tree_util.keystr(path)
        if "rotation" not in name:
            continue
        g = got
        for k in path:
            g = g[getattr(k, "key", getattr(k, "idx", None))]
        out.append((name, g.copy(), w.copy()))
        g[...] = 0
        w[...] = 0
    assert out
    return out


def test_train_step_moves_only_the_first_log_scale():
    """Adam's moments of log-scale columns 1–2 stay exactly 0 (zero
    gradient) on both sides, and the stored columns keep their values."""
    (jp1, ja1, _, _), (tp1, ta1, _, _) = _steps()
    for mu in (np.asarray(ja1.mu["scaling"]), ta1.mu["scaling"].numpy()):
        assert (mu[:, 1:] == 0).all() and np.abs(mu[:, 0]).max() > 0
    cfg, jstate = _scene(0, True, seed=3)
    s0 = np.asarray(jstate.params["scaling"])
    for s in (np.asarray(jp1["scaling"]), tp1["scaling"].detach().numpy()):
        np.testing.assert_array_equal(s[:, 1:], s0[:, 1:])
        assert not np.array_equal(s[:, 0], s0[:, 0])


def _iso_state(n_alive, seed=0):
    """``test_torch_densify``'s state with the first scale of each live
    Gaussian drawn apart, U(0.005, 0.06) about the split size 0.03, so the
    isotropic size (the first column) and the largest of three select
    differently for many (those whose other scales are 20× larger and first
    is small, those whose first alone passes the split size)."""
    js, jm = _jax_state(n_alive, seed)
    alive = np.asarray(js.alive)
    s = np.array(js.params["scaling"])
    s[alive, 0] = np.log(np.random.default_rng(seed + 9).uniform(0.005, 0.06, alive.sum()))
    js = js._replace(params={**js.params, "scaling": jnp.asarray(s)})
    small = np.exp(s[alive]) <= PD * EXTENT
    assert (small[:, 0] != small.all(1)).mean() > 0.1
    return js, jm


@pytest.mark.parametrize("room", sorted(ROOMS))
def test_isotropic_clone_and_split_match_jax(room):
    js, jm = _iso_state(ROOMS[room])
    ts, tm = _carry(js, jm)
    grads_j = jdens.compute_grads(js)
    grads_t = tdens.compute_grads(ts)
    thr = float(np.median(np.asarray(grads_j)[np.asarray(js.alive)]))
    ext = jnp.float32(EXTENT)
    js1, jm1, jn = jdens.densify_and_clone(js, jm, grads_j, jnp.float32(thr), ext, PD,
                                           isotropic=True)
    ts1, tm1, tn = tdens.densify_and_clone(ts, tm, grads_t, thr, EXTENT, PD,
                                           isotropic=True)
    assert tn == int(jn) > 0
    if room == "roomy":     # the isotropic size selects other Gaussians
        aniso = tdens.densify_and_clone(ts, tm, grads_t, thr, EXTENT, PD)[0]
        assert not torch.equal(aniso.params["xyz"], ts1.params["xyz"])
    _assert_same(ts1, tm1, js1, jm1, "isotropic clone")

    key = jax.random.key(7)
    normals = torch.stack([torch.tensor(np.asarray(
        jax.random.normal(jax.random.fold_in(key, j), (CAP, 3)))) for j in range(2)])
    if room == "full":
        js1, jm1, ts1, tm1 = js, jm, ts, tm
    js2, jm2, jn2 = jdens.densify_and_split(key, js1, jm1, grads_j, jnp.float32(thr),
                                            ext, PD, isotropic=True)
    ts2, tm2, tn2 = tdens.densify_and_split(ts1, tm1, grads_t, thr, EXTENT, PD, normals,
                                            isotropic=True)
    assert tn2 == int(jn2) > 0
    _assert_same(ts2, tm2, js2, jm2, "isotropic split")
    # the children take log(first scale / 1.6) in all three columns
    new = (ts2.alive & ~ts1.alive).numpy()
    child = ts2.params["scaling"].numpy()[new]
    assert new.any() and (child == child[:, :1]).all()


@pytest.mark.parametrize("size_on", [False, True])
def test_isotropic_prune_matches_jax(size_on):
    js, jm = _iso_state(ROOMS["roomy"])
    ts, _ = _carry(js, jm)
    jp, jn = jdens.prune(js, jnp.float32(0.2), jnp.float32(EXTENT), size_on,
                         isotropic=True)
    tp, tn = tdens.prune(ts, 0.2, EXTENT, size_on, isotropic=True)
    assert int(tn) == int(jn) > 0
    np.testing.assert_array_equal(tp.alive.numpy(), np.asarray(jp.alive))
    if size_on:    # the world-size criterion reads the first scale only
        assert int(tn) < int(tdens.prune(ts, 0.2, EXTENT, True)[1])


def test_make_maintenance_passes_isotropic():
    """``make_maintenance`` of an isotropic config runs the isotropic
    clone, split and prune (it raised before the mode was ported)."""
    js, jm = _iso_state(ROOMS["roomy"])
    ts, tm = _carry(js, jm)
    cfg = _tiny_cfg()
    cfg.opt.percent_dense = PD
    densify, prune, _ = tloop.make_maintenance(cfg)
    cfg.model.use_isotropic_gaussian = True
    densify_iso, prune_iso, _ = tloop.make_maintenance(cfg)
    opt = tadam.AdamState(mu=tm[0], nu=tm[1], count=3)
    thr = float(np.median(tdens.compute_grads(ts).numpy()[ts.alive.numpy()]))
    normals = torch.zeros(2, CAP, 3)
    grads = tdens.compute_grads(ts)
    want, want_m, _ = tdens.densify_and_clone(ts, tm, grads, thr, EXTENT, PD, isotropic=True)
    want = tdens.densify_and_split(want, want_m, grads, thr, EXTENT, PD, normals,
                                   isotropic=True)[0]
    got = densify_iso(ts, opt, thr, EXTENT, normals)[0]
    assert torch.equal(got.params["xyz"], want.params["xyz"])
    assert torch.equal(got.params["scaling"], want.params["scaling"])
    assert not torch.equal(densify(ts, opt, thr, EXTENT, normals)[0].params["xyz"],
                           want.params["xyz"])
    assert int(prune_iso(ts, 0.2, EXTENT, True)[1]) == int(
        tdens.prune(ts, 0.2, EXTENT, True, isotropic=True)[1])
    assert math.isfinite(thr)
