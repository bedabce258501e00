"""The train step of the port against the JAX package's, and its parts.

- ``utils/losses``, ``hexplane_regularization``, ``learning_rates``,
  ``adam.update`` on identical gradients, the densification statistics and
  the deformation's group labels, each against its JAX function;
- the whole step, ``fourdgs_tpu_torch.train.loop.make_train_step`` against
  ``fourdgs_tpu.train.loop.make_train_step`` (the Pallas kernels under the
  interpreter), on the ``_tiny_cfg`` scene with ``lambda_dssim = 0``: step 1
  from the same state, compared through the metrics, the Adam moments
  (``mu = 0.1·g``, ``nu = 0.001·g²``: the gradients themselves) and the
  densification statistics; then step 2 in both from the same carried JAX
  state (``interop`` brings params and Adam state across), compared through
  the parameters.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_cfg, _tiny_scene
from fourdgs_tpu import render as JR
from fourdgs_tpu.models import densify as jdens
from fourdgs_tpu.models import deformation as jdeform
from fourdgs_tpu.models import hexplane as jhp
from fourdgs_tpu.models.gaussians import inverse_sigmoid
from fourdgs_tpu.ops import pallas_blend as PB
from fourdgs_tpu.train import adam as jadam
from fourdgs_tpu.train import loop as jloop
from fourdgs_tpu.utils import graphics
from fourdgs_tpu.utils import losses as jlosses
from fourdgs_tpu_torch import interop
from fourdgs_tpu_torch import render as TR
from fourdgs_tpu_torch.models import densify as tdens
from fourdgs_tpu_torch.models import gaussians as TG
from fourdgs_tpu_torch.models import hexplane as thp
from fourdgs_tpu_torch.models.deformation import split_param_labels
from fourdgs_tpu_torch.ops import blend as tblend
from fourdgs_tpu_torch.ops import rasterize as trast
from fourdgs_tpu_torch.train import adam as tadam
from fourdgs_tpu_torch.train import loop as tloop
from fourdgs_tpu_torch.utils import losses as tlosses
from tests.test_torch_math import warm_cpu_math  # noqa: F401  (autouse)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def tiny():
    cfg = _tiny_cfg()
    return cfg, _tiny_scene(cfg)


# -- the parts ---------------------------------------------------------------


@pytest.mark.parametrize("h,w", [(64, 64), (56, 72)])
def test_losses_match_jax(h, w):
    rng = np.random.default_rng(h)
    a = rng.uniform(0, 1, (2, 3, h, w)).astype(np.float32)
    b = rng.uniform(0, 1, (2, 3, h, w)).astype(np.float32)
    np.testing.assert_allclose(float(tlosses.l1_loss(_t(a), _t(b))),
                               float(jlosses.l1_loss(a, b)), rtol=1e-6)
    np.testing.assert_allclose(tlosses.psnr(_t(a), _t(b)).numpy(),
                               np.asarray(jlosses.psnr(a, b)), rtol=1e-6)
    for pad in (0, 2):
        np.testing.assert_array_equal(
            tlosses.tile_image(_t(a[0]), pad_cols=pad).numpy(),
            np.asarray(jlosses.tile_image(jnp.asarray(a[0]), pad_cols=pad)))
    u8 = (a[0].transpose(1, 2, 0) * 255).astype(np.uint8)
    np.testing.assert_array_equal(tlosses.tile_image_np(u8),
                                  jlosses.tile_image_np(u8))
    np.testing.assert_array_equal(tlosses.tile_pixel_mask(h, w, device="cpu").numpy(),
                                  np.asarray(jlosses.tile_pixel_mask(h, w)))


def test_hexplane_regularization_matches_jax():
    cfg = _tiny_cfg()
    rng = np.random.default_rng(0)
    planes = {k: rng.uniform(0.5, 1.5, v.shape).astype(np.float32) for k, v in
              jhp.init_hexplane(jax.random.key(0), cfg.hidden.kplanes_config,
                                cfg.hidden.multires).items()}
    weights = (1e-3, 0.02, 5e-3)
    n = len(cfg.hidden.multires)
    want, want_g = jax.jit(jax.value_and_grad(
        lambda p: jhp.hexplane_regularization(p, n, *weights)))(
            {k: jnp.asarray(v) for k, v in planes.items()})
    tp = {k: _t(v).requires_grad_() for k, v in planes.items()}
    got = thp.hexplane_regularization(tp, n, *weights)
    got_g = torch.autograd.grad(got, list(tp.values()))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    for k, g in zip(tp, got_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_g[k]),
                                   rtol=1e-5, atol=1e-12, err_msg=k)


def test_learning_rates_match_jax():
    opt = _tiny_cfg().opt
    for step in (0, 1, 7, 500, 20_000, 30_000):
        for sls in (1.0, 2.5):
            got = tadam.learning_rates(step, opt, sls)
            want = jadam.learning_rates(step, opt, sls)
            assert got.keys() == want.keys()
            for k in got:   # float32 schedules: equal up to an ulp
                np.testing.assert_allclose(got[k], float(want[k]), rtol=3e-7,
                                           err_msg=f"{k} at {step}")
    for step in (0, 3, 10, 50):   # the sine delay
        np.testing.assert_allclose(
            tadam.expon_lr(step, 1e-3, 1e-5, 20, 0.01, 100),
            float(jadam.expon_lr(step, 1e-3, 1e-5, 20, 0.01, 100)), rtol=3e-7)
    assert tadam.expon_lr(5, 0.0, 0.0) == 0.0


def _port_state(jstate, cfg):
    params_np = jax.tree.map(np.asarray, jstate.params)
    t = interop.from_jax_numpy(params_np, np.asarray(jstate.alive),
                               np.asarray(jstate.aabb), cfg, device="cpu")
    return t._replace(**{k: _t(getattr(jstate, k)) for k in (
        "max_radii2d", "xyz_gradient_accum", "denom", "deformation_accum")})


def test_param_labels_and_lr_tree_match_jax(tiny):
    cfg, jstate = tiny
    tstate = _port_state(jstate, cfg)
    deform = tstate.params["deform"]
    labels = split_param_labels(deform)
    got = interop.named_to_tree({n: torch.tensor(float(v == "grid"))
                                 for n, v in labels.items()})
    want = jdeform.split_param_labels(jstate.params["deform"])
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert bool(g == 1.0) == (w == "grid")
    lrs = tadam.learning_rates(3, cfg.opt, 1.0)
    tree = tadam.lr_tree_for_params(tstate.params, lrs)
    want_tree = jadam.lr_tree_for_params(jstate.params,
                                         jadam.learning_rates(3, cfg.opt, 1.0))
    got_tree = {k: tree[k] for k in TG.PRIMITIVE_KEYS}
    got_tree["deform"] = interop.named_to_tree(
        {n: torch.tensor(v) for n, v in tree["deform"].items()})
    for g, w in zip(jax.tree.leaves(got_tree), jax.tree.leaves(want_tree)):
        np.testing.assert_allclose(float(g), float(w), rtol=3e-7)


def _jax_adam(mu, nu, count):
    return jadam.AdamState(mu=jax.tree.map(jnp.asarray, mu),
                           nu=jax.tree.map(jnp.asarray, nu),
                           count=jnp.int32(count))


def test_adam_update_matches_jax(tiny):
    """Two steps on identical gradients: the same float32 formula, equal up
    to the rounding of its few operations."""
    cfg, jstate = tiny
    tstate = _port_state(jstate, cfg)
    jp, js = jstate.params, jadam.init(jstate.params)
    tp, ts = tstate.params, tadam.init(tstate.params)
    rng = np.random.default_rng(5)
    for step in (1, 2):
        gnp = jax.tree.map(
            lambda x: (rng.normal(size=x.shape) * 10.0 ** rng.integers(-6, 0)
                       ).astype(np.float32), jax.tree.map(np.asarray, jp))
        jp, js = jadam.update(jp, jax.tree.map(jnp.asarray, gnp), js,
                              jadam.lr_tree_for_params(
                                  jp, jadam.learning_rates(step, cfg.opt, 1.0)))
        g_port = {k: _t(gnp[k]) for k in TG.PRIMITIVE_KEYS}
        g_port["deform"] = {n: _t(a) for n, a in interop.tree_to_named(
            gnp["deform"], tp["deform"]).items()}
        tp, ts = tadam.update(tp, g_port, ts, tadam.lr_tree_for_params(
            tp, tadam.learning_rates(step, cfg.opt, 1.0)))
    assert ts.count == int(js.count) == 2
    got_p, _, _ = interop.to_numpy(tstate._replace(params=tp))
    mu, nu, _ = interop.adam_to_numpy(ts)
    for got, want in ((got_p, jp), (mu, js.mu), (nu, js.nu)):
        assert jax.tree.structure(got) == jax.tree.structure(
            jax.tree.map(np.asarray, want))
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g, np.asarray(w), rtol=2e-6, atol=1e-30)


def test_densification_stats_match_jax(tiny):
    cfg, jstate = tiny
    tstate = _port_state(jstate, cfg)
    rng = np.random.default_rng(2)
    P = jstate.alive.shape[0]
    for _ in range(2):
        g = rng.normal(size=(P, 2)).astype(np.float32) * 1e-3
        radii = rng.integers(0, 4, P).astype(np.int32)
        jstate = jdens.add_densification_stats(jstate, jnp.asarray(g),
                                               jnp.asarray(radii), 72, 56)
        tstate = tdens.add_densification_stats(tstate, _t(g), _t(radii), 72, 56)
    for k in ("max_radii2d", "denom"):
        np.testing.assert_array_equal(getattr(tstate, k).numpy(),
                                      np.asarray(getattr(jstate, k)), err_msg=k)
    np.testing.assert_allclose(tstate.xyz_gradient_accum.numpy(),
                               np.asarray(jstate.xyz_gradient_accum), rtol=1e-6)
    np.testing.assert_allclose(tdens.compute_grads(tstate).numpy(),
                               np.asarray(jdens.compute_grads(jstate)), rtol=1e-6)
    assert int(TG.count_alive(tstate)) == int(jnp.sum(jstate.alive))


def test_adam_state_interop_round_trip(tiny):
    cfg, jstate = tiny
    tstate = _port_state(jstate, cfg)
    rng = np.random.default_rng(0)
    mu = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32),
                      jax.tree.map(np.asarray, jstate.params))
    nu = jax.tree.map(np.abs, mu)
    st = interop.adam_from_jax_numpy(mu, nu, 7, tstate.params)
    assert st.count == 7
    assert tuple(st.mu["deform"]["feature_out.0.weight"].shape) == tuple(
        tstate.params["deform"].feature_out[0].weight.shape)
    mu2, nu2, count = interop.adam_to_numpy(st)
    assert count == 7
    for a, b in zip(jax.tree.leaves(mu2) + jax.tree.leaves(nu2),
                    jax.tree.leaves(mu) + jax.tree.leaves(nu)):
        np.testing.assert_array_equal(a, b)


def test_train_step_requires_cuda_and_builds_with_ssim():
    """D-SSIM is ported (``tests/test_torch_dssim.py`` holds it against
    JAX): the step builds with ``lambda_dssim != 0`` on the CPU, and without
    CUDA it still raises unless asked for the CPU."""
    cfg = _tiny_cfg()
    assert cfg.opt.lambda_dssim != 0
    assert callable(tloop.make_train_step(cfg, 64, 64, "fine", 1, device="cpu"))
    cfg.opt.lambda_dssim = 0.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tloop.make_train_step(cfg, 64, 64, "fine", 1)


# -- the whole step ----------------------------------------------------------


def _camera(i, w, h, time):
    ang = 0.7 + 0.35 * i
    eye = np.array([2.5 * math.sin(ang), 0.4, -2.5 * math.cos(ang)])
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(np.array([0.0, -1.0, 0.0]), fwd)
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd], axis=1)
    return graphics.make_camera(R, -R.T @ eye, math.pi / 3, math.pi / 3 * h / w,
                                w, h, time=time)


# (stage, batch, white background, H, W, GT form)
STEP_CASES = {
    "fine-b2-white-float": ("fine", 2, True, 64, 64, "float_chw"),
    "fine-padded-uint8": ("fine", 1, False, 56, 72, "uint8_hwc"),
    "coarse-pretiled": ("coarse", 1, True, 64, 64, "uint8_tiles"),
}


def _gt_forms(img, form):
    """[B, 3, H, W] float in [0, 1] → the GT form the step is given (the
    same quantized pixels in every form)."""
    u8 = np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
    if form == "float_chw":
        return u8.astype(np.float32) / 255.0
    if form == "uint8_hwc":
        return np.ascontiguousarray(u8.transpose(0, 2, 3, 1))
    return np.stack([jlosses.tile_image_np(x.transpose(1, 2, 0)) for x in u8])


def _setup(case):
    stage, B, white, h, w, form = STEP_CASES[case]
    cfg = _tiny_cfg()
    cfg.opt.lambda_dssim = 0.0
    cfg.model.white_background = white
    assert cfg.hidden.time_smoothness_weight != 0     # regularizer on the path
    jstate = _tiny_scene(cfg, seed=3)
    params = dict(jstate.params)
    # opacities ×0.1: transmittance clear of T_STOP (test_torch_render.py)
    params["opacity"] = inverse_sigmoid(0.1 * jax.nn.sigmoid(params["opacity"]))
    jstate = jstate._replace(params=params)
    cams = [_camera(i, w, h, time=0.2 + 0.5 * i) for i in range(B)]
    jcams = jax.tree.map(lambda *xs: jnp.stack(xs),
                         *[JR.CameraArrays.from_camera(c) for c in cams])
    tcams = TR.CameraArrays(*(_t(np.asarray(x)) for x in jcams))
    img = np.random.default_rng(11).uniform(0, 1, (B, 3, h, w)).astype(np.float32)
    gts = _gt_forms(img, form)
    return cfg, stage, w, h, jstate, jcams, tcams, gts


def _leaves_close(got_tree, want_tree, rtol, rel_atol, what):
    """Leaf for leaf; ``rel_atol`` × the leaf's largest |value| absorbs the
    float32 noise of elements far below the leaf's scale."""
    want_tree = jax.tree.map(np.asarray, want_tree)
    assert jax.tree.structure(got_tree) == jax.tree.structure(want_tree)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(want_tree)[0]]
    for path, g, w in zip(paths, jax.tree.leaves(got_tree),
                          jax.tree.leaves(want_tree)):
        scale = float(np.abs(w).max()) if w.size else 0.0
        np.testing.assert_allclose(g, w, rtol=rtol, atol=rel_atol * scale + 1e-30,
                                   err_msg=f"{what}{path}")


@functools.cache
def _jax_step1(case):
    """(``_setup(case)``, JAX's jitted step, its step 1 from the set-up
    state), computed once per process: the whole-step test and the gate
    test share the JAX step (about 40 s under the interpreter). Callers
    only read the results."""
    cfg, stage, w, h, jstate, jcams, tcams, gts = setup = _setup(case)
    jstep = jloop.make_train_step(cfg, w, h, stage, active_sh_degree=1)
    j1 = jstep(jstate.params, jadam.init(jstate.params), jstate, jcams,
               jnp.asarray(gts), 1)
    return setup, jstep, j1


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_matches_jax(case):
    (cfg, stage, w, h, jstate, jcams, tcams, gts), jstep, j1 = _jax_step1(case)
    tstep = tloop.make_train_step(cfg, w, h, stage, 1, device="cpu")

    # step 1 from the same state
    tstate = _port_state(jstate, cfg)
    t1 = tstep(tstate.params, tadam.init(tstate.params), tstate, tcams, _t(gts), 1)
    jp1, ja1, js1, jm1 = j1
    tp1, ta1, ts1, tm1 = t1
    for k in ("num_rendered", "max_tile_len", "n_points"):
        assert int(tm1[k]) == int(jm1[k]), k
    assert int(tm1["num_rendered"]) > 0
    for k in ("loss", "l1", "psnr"):
        np.testing.assert_allclose(float(tm1[k]), float(jm1[k]), rtol=1e-5, err_msg=k)
    mu, nu, count = interop.adam_to_numpy(ta1)
    assert count == int(ja1.count) == 1
    _leaves_close(mu, ja1.mu, 4e-3, 2e-3, "mu")
    _leaves_close(nu, ja1.nu, 8e-3, 4e-3, "nu")
    for k in ("max_radii2d", "denom"):
        np.testing.assert_array_equal(getattr(ts1, k).numpy(),
                                      np.asarray(getattr(js1, k)), err_msg=k)
    np.testing.assert_allclose(ts1.xyz_gradient_accum.numpy(),
                               np.asarray(js1.xyz_gradient_accum), rtol=4e-3,
                               atol=2e-3 * float(np.abs(js1.xyz_gradient_accum).max()))
    np.testing.assert_allclose(ts1.deformation_accum.numpy(),
                               np.asarray(js1.deformation_accum), rtol=1e-5, atol=1e-6)

    # step 2 from the same carried JAX state
    t_loss2, j_loss2 = _step2(case)[3:]
    np.testing.assert_allclose(t_loss2, j_loss2, rtol=1e-5)
    # Adam's step-2 move is lr·m̂/√v̂, bounded by about lr, with a slope of
    # ~1/|g| in the step's gradient: float32 noise in a gradient small next
    # to its leaf, or one pixel's α ≥ 1/255 gate decided the other way,
    # moves it by a fraction of lr. So every element within 0.1·lr of JAX
    # and at most 1% of a leaf beyond 0.01·lr (measured: 0.072·lr and 0.2%
    # at most).
    # The gate, isolated in the batch-2 case: on the step-2 state exactly
    # one pixel takes another gate than in JAX, (44, 18) of camera 1 under
    # Gaussian 232, whose payload differs from JAX's by float32 rounding,
    # 1 ulp at most (the projection sums in another order). Its α sits 7
    # ulps of 1/255 below the α ≥ 1/255 floor here (pixel dropped) and 8
    # above it in JAX's own α (pixel blended). The three elements beyond
    # 0.01·lr are Gaussian 232's rotation and xyz and a hexplane cell it
    # samples (test_step2_gates_differ_only_at_the_threshold).
    for keys, moved in _step2_moves(case):
        assert moved.max() <= 0.1, (keys, moved.max())
        assert (moved > 0.01).mean() <= 0.01, (keys, (moved > 0.01).mean())


@functools.cache
def _step2(case):
    """Step 2 of both sides from the same carried JAX state (JAX's
    parameters, Adam state and statistics after its step 1): (the port's
    parameters as JAX's tree of numpy, JAX's, the step's lr tree, the
    port's loss, JAX's loss). Cached as :func:`_jax_step1`."""
    (cfg, stage, w, h, _, jcams, tcams, gts), jstep, (jp1, ja1, js1, _) = _jax_step1(case)
    js1 = js1._replace(params=jp1)
    ts2_in = _port_state(js1, cfg)
    ta2_in = interop.adam_from_jax_numpy(jax.tree.map(np.asarray, ja1.mu),
                                         jax.tree.map(np.asarray, ja1.nu),
                                         int(ja1.count), ts2_in.params)
    jp2, _, _, jm2 = jstep(jp1, ja1, js1, jcams, jnp.asarray(gts), 2)
    tstep = tloop.make_train_step(cfg, w, h, stage, 1, device="cpu")
    tp2, _, _, tm2 = tstep(ts2_in.params, ta2_in, ts2_in, tcams, _t(gts), 2)
    got_p2, _, _ = interop.to_numpy(ts2_in._replace(params=tp2))
    lr_tree = jadam.lr_tree_for_params(jp1, jadam.learning_rates(2, cfg.opt, 1.0))
    return (got_p2, jax.tree.map(np.asarray, jp2), lr_tree, float(tm2["loss"]),
            float(jm2["loss"]))


def _step2_moves(case):
    """[(leaf keys, |port − JAX| / lr)] of step 2's parameters, leaf by
    leaf; keys such as ``("rotation",)`` or ``("deform", "grid_s0_p3")``."""
    got, want, lr_tree = _step2(case)[:3]
    return [(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path),
             np.abs(g - w) / float(lr))
            for (path, lr), g, w in zip(jax.tree_util.tree_flatten_with_path(lr_tree)[0],
                                        jax.tree.leaves(got), jax.tree.leaves(want))]


def test_step2_gates_differ_only_at_the_threshold(monkeypatch):
    """The evidence for the step-2 bound above, on the batch-2 case's
    carried state. The tile ranges of both sides' blend inputs (JAX's from
    its jitted render) are equal and their payloads agree to float32
    rounding. The port's gates come from its walk (``ops/blend.py``) on its
    payload, JAX's from its kernel's own α (``pallas_blend.py::_chunk_alpha``)
    on JAX's payload. No pixel's transmittance reaches T_STOP, so the keep
    gate is the only one that can differ. Every pixel whose gate differs
    (at least one) has α within 16 ulps of 1/255 on both sides, under a
    Gaussian whose payload differs from JAX's by at most 2 ulps, and every
    element of step 2's parameters more than 0.01·lr from JAX's belongs to
    such a Gaussian: its row of a per-Gaussian leaf, or a hexplane cell it
    samples at a camera's time. Measured: one pixel, Gaussian 232 at
    (44, 18) of camera 1, α 7 ulps below the floor in the port and 8 above
    in JAX, payload 1 ulp apart; its rotation and xyz rows and one cell of
    ``grid_s0_p3`` moved beyond 0.01·lr."""
    case = "fine-b2-white-float"
    (cfg, stage, w, h, _, jcams, tcams, _), _, (jp1, _, js1, _) = _jax_step1(case)
    js1 = js1._replace(params=jp1)
    ts = _port_state(js1, cfg)
    captured = []
    blend_pallas = PB.blend_pallas

    def capture(feat, starts, stops, *rest):
        jax.debug.callback(lambda *a: captured.append([np.asarray(x) for x in a]),
                           feat, starts, stops)
        return blend_pallas(feat, starts, stops, *rest)

    monkeypatch.setattr(PB, "blend_pallas", capture)
    jax_alpha = jax.jit(jax.vmap(PB._chunk_alpha))   # over a chunk's tiles
    bg = jnp.ones(3)
    P = jp1["xyz"].shape[0]
    floor = np.float32(1.0 / 255.0)
    ulp = float(np.spacing(floor))
    row_off = torch.tensor([0, 1])
    flips = []
    for b in range(2):
        jcam = jax.tree.map(lambda x: x[b], jcams)
        jax.block_until_ready(jax.jit(lambda p: JR.render(
            p, js1, jcam, cfg, w, h, stage, bg, 1, means2d_offset=jnp.zeros((P, 2)),
            tile_space=True).color)(jp1))
        j_feat, j_starts, j_stops = captured.pop()
        tcam = TR.CameraArrays(*(x[b] for x in tcams))
        with torch.no_grad():
            xyz, sc, rot, op, shs, _ = TR.activated_gaussians(ts.params, ts, tcam, stage)
            bi = trast.blend_inputs(xyz, sc, rot, op, shs, tcam.camera_center,
                                    tcam.world_view, tcam.full_proj, tcam.tanfovx,
                                    tcam.tanfovy, w, h, 1, cfg.tpu.instance_budget,
                                    alive=ts.alive, means2d_offset=torch.zeros((P, 2)))
        starts, stops = bi.bins.tile_start, bi.bins.tile_stop
        np.testing.assert_array_equal(starts.numpy(), j_starts)
        np.testing.assert_array_equal(stops.numpy(), j_stops)
        np.testing.assert_allclose(bi.feat.numpy(), j_feat, rtol=1e-5, atol=1e-5)
        K = j_feat.shape[1]
        for tiles, start, stop, off0, n_chunks in tblend._tile_groups(starts, stops, K):
            px, py = tblend._pixel_coords(tiles, bi.grid_x, row_off)
            Tv = torch.ones((tiles.shape[0], 256))
            for ch in tblend._walk_chunks(bi.feat, start, stop, off0, n_chunks,
                                          px, py, Tv):
                a = ch.act
                assert bool((ch.contrib | ~ch.inside[:, None, :]).all())
                _, a_j, _, keep_j, _, _ = jax_alpha(
                    j_feat[:, np.minimum(ch.g.numpy(), K - 1)].transpose(1, 0, 2),
                    px[a].numpy()[:, :, None], py[a].numpy()[:, :, None],
                    ch.g[:, 0].numpy().astype(np.int32),
                    start[a, 0].numpy().astype(np.int32),
                    stop[a, 0].numpy().astype(np.int32))
                differ = (ch.keep.numpy() != np.asarray(keep_j)) & ch.inside.numpy()[:, None, :]
                for i, p_, c in np.argwhere(differ):
                    slot = int(ch.g[i, c])
                    margins = [(float(x) - float(floor)) / ulp
                               for x in (ch.alpha_raw[i, p_, c], a_j[i, p_, c])]
                    want = j_feat[:10, slot]
                    ulps = np.abs(bi.feat[:10, slot].numpy() - want) / np.spacing(np.abs(want))
                    flips.append((b, int(bi.bins.gauss_id[slot]), int(tiles[a[i]]), int(p_),
                                  margins, float(ulps.max())))
    assert 1 <= len(flips) <= 2, flips
    for flip in flips:
        b, gid, tile, p_, margins, payload_ulps = flip
        # the sides' payloads differ by float32 rounding, and the gate sits
        # on its threshold (measured: 7 ulps below it here, 8 above in JAX)
        assert payload_ulps <= 2 and all(abs(m) <= 16 for m in margins), flip

    # the hexplane cells the flipped Gaussians sample at the cameras' times
    gids = sorted({f[1] for f in flips})
    deform = ts.params["deform"]
    grids = {n: p for n, p in deform.named_parameters() if n.startswith("grids.")}
    reads = {n: torch.zeros(p.shape, dtype=torch.bool) for n, p in grids.items()}
    for b in range(2):
        feats = thp.query_hexplane(deform.grids, ts.aabb, ts.params["xyz"].detach()[gids],
                                   tcams.time[b], len(cfg.hidden.multires))
        for n, g in zip(grids, torch.autograd.grad(feats.sum(), list(grids.values()))):
            reads[n] |= g != 0
    reads = interop.named_to_tree(reads)
    beyond = []
    for keys, moved in _step2_moves(case):
        for idx in map(tuple, np.argwhere(moved > 0.01)):
            beyond.append((keys, idx))
            if keys[0] in TG.PRIMITIVE_KEYS:
                assert idx[0] in gids, (keys, idx, gids)
            else:
                assert keys[1] in reads and reads[keys[1]][idx], (keys, idx, gids)
    assert beyond, "no element of step 2 moved beyond 0.01·lr"
