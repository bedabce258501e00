"""The sharded trainer of the port against the JAX package's
``fourdgs_tpu.parallel``, at ``tests/test_parallel.py``'s sizes (48
Gaussians in 256 slots, ``sp_cfg()``'s narrow field, 32×32 and 32×64
images):

- the slab render (``rasterize_pallas`` with ``tile_row_offset``,
  ``tile_rows`` and ``tile_row_stride``), forward and gradient, against
  JAX's under the Pallas interpreter, at (offset, stride) = (0, 2), (1, 2)
  and (3, 4) with the ellipse cull off and on, and ``rasterize_from_table``
  against JAX's on the same table;
- ``interleave_gt_rows``, ``deinterleave_rows``, ``place_batch``,
  ``parse_mesh_arg`` and the hybrid layout's rules against JAX's;
- one sharded step on a 2×2 grid of four CPU gloo ranks against JAX's
  ``make_sharded_train_step`` on the 2×2 virtual mesh, leaf for leaf, in
  the four modes (``shard_preprocess``, replicated, ``shard_primitives``,
  both), the first with D-SSIM and the grid regularizer on, and every
  rank's state equal bit for bit.

JAX compiles each program once per process (``functools.cache``); the
ranks run once for all four modes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs_tpu.ops import rasterize as jrast
from fourdgs_tpu.parallel import mesh as jmesh
from fourdgs_tpu.parallel import multihost as jmultihost
from fourdgs_tpu.parallel import trainer as jtrainer
from fourdgs_tpu.train import adam as jadam
from fourdgs_tpu_torch import interop
from fourdgs_tpu_torch import render as TR
from fourdgs_tpu_torch.ops import rasterize as trast
from fourdgs_tpu_torch.ops.preprocess import preprocess as tpreprocess
from fourdgs_tpu_torch.parallel import mesh as tmesh
from fourdgs_tpu_torch.parallel import multihost as tmultihost
from fourdgs_tpu_torch.parallel import trainer as ttrainer
from fourdgs_tpu_torch.parallel.launch import run_ranks
from fourdgs_tpu_torch.models import gaussians as TG
from tests.test_math_core import look_at_camera
from tests.test_parallel import build_state, make_batch, sp_cfg
from tests.test_torch_cli import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_math import warm_cpu_math  # noqa: F401  (autouse)
from tests.torch_parallel_ranks import MODES

# sp_cfg() on the port's config (tests/test_parallel.py:29-43)
SP_OVERRIDES = {
    "tpu.capacity": 256, "tpu.instance_budget": 1024,
    "hidden.kplanes_config": {"resolution": (8, 8, 8, 4), "output_coordinate_dim": 8},
    "hidden.multires": (1,), "hidden.net_width": 16, "hidden.defor_depth": 1,
    "hidden.no_dx": False, "model.sh_degree": 1, "model.white_background": False,
    "tpu.backend": "pallas",
}

# -- the slab render -----------------------------------------------------------

SLAB_W, SLAB_H, SLAB_SH = 32, 64, 1
SLABS = [(0, 2), (1, 2), (3, 4)]


@functools.cache
def _slab_scene():
    """48 activated Gaussians, a camera at 32×64 and the loss weights."""
    rng = np.random.default_rng(4)
    n = 48
    rot = rng.normal(size=(n, 4))
    g = {
        # tall in y, so that every tile row of the 32×64 image is reached
        "means3d": rng.uniform(-0.7, 0.7, (n, 3)) * np.array([1.0, 2.4, 1.0]),
        "scales": np.exp(rng.uniform(np.log(0.03), np.log(0.2), (n, 3))),
        "rotations": rot / np.linalg.norm(rot, axis=-1, keepdims=True),
        "opacities": rng.uniform(0.2, 0.9, (n, 1)),
        "shs": rng.normal(0.0, 0.4, (n, 4, 3)),
    }
    g = {k: v.astype(np.float32) for k, v in g.items()}
    cam = look_at_camera([0.3, 0.2, -3.0], [0, 0, 0], width=SLAB_W, height=SLAB_H,
                         time=0.4)
    w = {k: rng.uniform(-1, 1, (c, SLAB_H, SLAB_W)).astype(np.float32)
         for k, c in (("color", 3), ("depth", 1), ("alpha", 1))}
    return g, cam, w


def _slab_loss(out, w, rows):
    """Σ weights·output over the slab's image rows."""
    return sum((getattr(out, k) * w[k][:, :rows * 16]).sum() for k in w)


@functools.cache
def _jax_slab_fn(stride, cull):
    """JAX's slab render and its gradient, jitted once per (stride, cull):
    the offset is traced, as the sharded step traces ``axis_index``."""
    _, cam, w = _slab_scene()
    rows = -(-SLAB_H // 16) // stride
    jc = TR_JAX_CAMERA(cam)

    def loss(args, off):
        out = jrast.rasterize_pallas(
            *args, jc.camera_center, jc.world_view, jc.full_proj, jc.tanfovx,
            jc.tanfovy, SLAB_W, SLAB_H, SLAB_SH, jnp.zeros(3), 4096,
            interpret=True, tile_row_offset=off, tile_rows=rows,
            tile_row_stride=stride, ellipse_tile_cull=cull)
        return _slab_loss(out, w, rows), out

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def _jax_slab(offset, stride, cull):
    g, _, _ = _slab_scene()
    args = tuple(jnp.asarray(g[k]) for k in ("means3d", "scales", "rotations",
                                             "opacities", "shs"))
    (_, out), grads = _jax_slab_fn(stride, cull)(args, jnp.int32(offset))
    return jax.tree.map(np.asarray, (out, grads))


def TR_JAX_CAMERA(cam):
    from fourdgs_tpu.render import CameraArrays

    return CameraArrays.from_camera(cam)


@pytest.mark.parametrize("cull", [False, True])
@pytest.mark.parametrize("offset,stride", SLABS)
def test_slab_render_matches_jax(offset, stride, cull):
    g, cam, w = _slab_scene()
    rows = -(-SLAB_H // 16) // stride
    jout, jgrads = _jax_slab(offset, stride, cull)
    args = [torch.tensor(g[k], requires_grad=True) for k in
            ("means3d", "scales", "rotations", "opacities", "shs")]
    tc = TR.CameraArrays.from_camera(cam, device="cpu")
    out = trast.rasterize_pallas(
        *args, tc.camera_center, tc.world_view, tc.full_proj, tc.tanfovx, tc.tanfovy,
        SLAB_W, SLAB_H, SLAB_SH, torch.zeros(3), 4096, ellipse_tile_cull=cull,
        tile_row_offset=offset, tile_rows=rows, tile_row_stride=stride)
    grads = torch.autograd.grad(_slab_loss(out, {k: torch.tensor(v) for k, v in w.items()},
                                           rows), args)
    assert out.color.shape == (3, rows * 16, SLAB_W) == jout.color.shape
    assert int(out.num_rendered) == int(jout.num_rendered) > 0
    assert int(out.max_tile_len) == int(jout.max_tile_len)
    np.testing.assert_array_equal(out.radii.numpy(), jout.radii)
    np.testing.assert_allclose(out.color.detach().numpy(), jout.color, atol=1e-4)
    np.testing.assert_allclose(out.alpha.detach().numpy(), jout.alpha, atol=1e-4)
    np.testing.assert_allclose(out.depth.detach().numpy(), jout.depth, atol=2e-4)
    # gradients: rtol 1e-3 and 1e-4 of each leaf's largest |value|
    for name, a, b in zip(("means3d", "scales", "rotations", "opacities", "shs"),
                          grads, jgrads):
        scale = float(np.abs(b).max())
        assert scale > 0, name
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-3, atol=1e-4 * scale,
                                   err_msg=name)


def test_slab_rows_are_the_image_rows():
    """The slabs of (offset, stride) = (m, M) for m < M put back in image
    order are the whole image's render."""
    g, cam, _ = _slab_scene()
    tc = TR.CameraArrays.from_camera(cam, device="cpu")
    args = [torch.tensor(g[k]) for k in ("means3d", "scales", "rotations",
                                         "opacities", "shs")]
    common = (tc.camera_center, tc.world_view, tc.full_proj, tc.tanfovx, tc.tanfovy,
              SLAB_W, SLAB_H, SLAB_SH, torch.zeros(3), 4096)
    whole = trast.rasterize_pallas(*args, *common).color
    slabs = torch.cat([trast.rasterize_pallas(*args, *common, tile_row_offset=m,
                                              tile_rows=2, tile_row_stride=2).color
                       for m in range(2)], dim=1)
    np.testing.assert_allclose(ttrainer.deinterleave_rows(slabs, 2).numpy(),
                               whole.numpy(), atol=1e-6)


def test_rasterize_from_table_matches_jax():
    """The same table, rects, depths and radii through both sides'
    ``rasterize_from_table`` on the slab (1, 2), in tile space: the output
    and the table's gradient."""
    g, cam, _ = _slab_scene()
    tc = TR.CameraArrays.from_camera(cam, device="cpu")
    op = torch.tensor(g["opacities"]).reshape(-1)
    pre = tpreprocess(torch.tensor(g["means3d"]), torch.tensor(g["scales"]),
                      torch.tensor(g["rotations"]), torch.tensor(g["shs"]),
                      tc.camera_center, tc.world_view, tc.full_proj, tc.tanfovx,
                      tc.tanfovy, SLAB_W, SLAB_H, SLAB_SH, opacities=op)
    table = trast.payload_table(pre, op, pre.means2d).detach()
    ints = [pre.tile_min, pre.tile_max, pre.tiles_touched, pre.depths.detach(), pre.radii]
    rng = np.random.default_rng(9)
    T = (SLAB_W // 16) * 2
    cot = rng.uniform(-1, 1, (T, 5, 256)).astype(np.float32)

    def jax_loss(tab):
        out = jrast.rasterize_from_table(
            tab, *(jnp.asarray(x.numpy()) for x in ints), tab[:, 0:2], SLAB_W, SLAB_H,
            jnp.zeros(3), 4096, interpret=True, tile_row_offset=1, tile_rows=2,
            tile_row_stride=2, tile_space=True)
        return jnp.sum(out.color * cot), out

    (_, jout), jg = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jnp.asarray(table.numpy()))
    tab = table.clone().requires_grad_()
    out = trast.rasterize_from_table(tab, *ints, tab[:, 0:2], SLAB_W, SLAB_H,
                                     torch.zeros(3), 4096, tile_row_offset=1,
                                     tile_rows=2, tile_row_stride=2, tile_space=True)
    (tg,) = torch.autograd.grad((out.color * torch.tensor(cot)).sum(), tab)
    assert out.color.shape == (T, 5, 256)
    assert int(out.num_rendered) == int(jout.num_rendered) > 0
    np.testing.assert_allclose(out.color.detach().numpy(), np.asarray(jout.color), atol=2e-4)
    jg = np.asarray(jg)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-3, atol=1e-4 * np.abs(jg).max())


def test_slab_clip_renders_dead_gaussians_as_jax():
    """The slab's rect clip recomputes ``tiles_touched`` from the clipped
    rects (``rasterize.py:314-319``) without the alive gate ``preprocess``
    applied, so a dead Gaussian whose rect meets the slab is binned and
    blended with its payload. A fault of the reference that the port
    copies (ROADMAP Queue 3): with a third of the Gaussians dead, JAX's and
    the port's slab of every row (offset 0, stride 1) both equal the render
    with all of them alive, and the whole-image render leaves them out."""
    g, cam, _ = _slab_scene()
    keys = ("means3d", "scales", "rotations", "opacities", "shs")
    alive = np.arange(len(g["means3d"])) % 3 != 0
    rows = SLAB_H // 16
    slab = dict(tile_row_offset=0, tile_rows=rows, tile_row_stride=1)
    jc = TR_JAX_CAMERA(cam)
    jslab = jax.jit(lambda args, al: jrast.rasterize_pallas(
        *args, jc.camera_center, jc.world_view, jc.full_proj, jc.tanfovx, jc.tanfovy,
        SLAB_W, SLAB_H, SLAB_SH, jnp.zeros(3), 4096, alive=al, interpret=True,
        **slab).color)(tuple(jnp.asarray(g[k]) for k in keys), jnp.asarray(alive))
    tc = TR.CameraArrays.from_camera(cam, device="cpu")
    common = ([torch.tensor(g[k]) for k in keys], tc.camera_center, tc.world_view,
              tc.full_proj, tc.tanfovx, tc.tanfovy, SLAB_W, SLAB_H, SLAB_SH,
              torch.zeros(3), 4096)

    def render(**kw):
        return trast.rasterize_pallas(*common[0], *common[1:], **kw).color.numpy()

    every = render()
    t_slab = render(alive=torch.tensor(alive), **slab)
    np.testing.assert_allclose(t_slab, np.asarray(jslab), atol=1e-4)
    np.testing.assert_allclose(t_slab, every, atol=1e-6)
    assert np.abs(render(alive=torch.tensor(alive)) - every).max() > 0.05


# -- layouts -------------------------------------------------------------------


@pytest.mark.parametrize("n_model,shape", [(1, (2, 3, 64, 32)), (2, (2, 3, 64, 32)),
                                           (4, (1, 4, 64, 48)), (2, (2, 3, 56, 32)),
                                           (4, (2, 3, 32, 32))])
def test_interleave_matches_jax(n_model, shape):
    x = np.random.default_rng(1).uniform(0, 1, shape).astype(np.float32)
    got = ttrainer.interleave_gt_rows(torch.tensor(x), n_model).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jtrainer.interleave_gt_rows(jnp.asarray(x), n_model)))
    if shape[2] % 16 == 0 and (shape[2] // 16) % n_model == 0:
        back = ttrainer.deinterleave_rows(torch.tensor(got), n_model).numpy()
        np.testing.assert_array_equal(
            back, np.asarray(jtrainer.deinterleave_rows(jnp.asarray(got), n_model)))
        np.testing.assert_array_equal(back, x)


def _fake_mesh(n_data, n_model, d, m):
    """A Mesh of one grid position, for the layouts that use no group."""
    return tmesh.Mesh({"data": n_data, "model": n_model}, d, m, None, None, None, ())


def test_place_batch_matches_jax_shards():
    """Rank (d, m)'s cameras and GT rows are the shard JAX places on mesh
    device (d, m)."""
    cams, gts = make_batch(4, 32, 64)
    jm = jmesh.make_mesh(2, 2)
    jc, jg = jtrainer.place_batch(jm, cams, gts)
    devs = np.asarray(jm.devices)
    shards = {s.device: np.asarray(s.data) for s in jg.addressable_shards}
    cam_shards = {s.device: np.asarray(s.data) for s in jc.full_proj.addressable_shards}
    tcams = TR.CameraArrays(*(torch.tensor(np.asarray(x)) for x in cams))
    for d in range(2):
        for m in range(2):
            c, g = ttrainer.place_batch(_fake_mesh(2, 2, d, m), tcams,
                                        torch.tensor(np.asarray(gts)))
            np.testing.assert_array_equal(g.numpy(), shards[devs[d, m]])
            np.testing.assert_array_equal(c.full_proj.numpy(), cam_shards[devs[d, m]])
            # host_local_batch from the rank's own cameras: the same
            sl = tmultihost.local_batch_slice(4, _fake_mesh(2, 2, d, m))
            _, g2 = tmultihost.host_local_batch(_fake_mesh(2, 2, d, m), None,
                                                np.array(gts)[sl])
            np.testing.assert_array_equal(g2.numpy(), g.numpy())
    with pytest.raises(ValueError):
        ttrainer.place_batch(_fake_mesh(3, 1, 0, 0), tcams, torch.tensor(np.asarray(gts)))


@pytest.mark.parametrize("spec", ["data=2,model=4", "model=8", "data=3", " data=1 , model=2",
                                  "tp=2", "data=0", "data=", "data=2,model=-1"])
def test_parse_mesh_arg_matches_jax(spec):
    try:
        want = jmesh.parse_mesh_arg(spec)
    except ValueError:
        with pytest.raises(ValueError):
            tmesh.parse_mesh_arg(spec)
        return
    assert tmesh.parse_mesh_arg(spec) == want


# (n_data, n_model, processes, local devices): JAX's devices are the port's
# ranks, a process's local devices a host's ranks
LAYOUTS = [(2, 4, 1, 8), (8, 1, 1, 8), (2, 2, 1, 8), (4, 4, 1, 8), (1, 1, 1, 8),
           (2, 4, 2, 4), (4, 2, 2, 4), (8, 1, 2, 4), (1, 8, 2, 4), (2, 2, 2, 4),
           (2, 3, 2, 4), (4, 2, 4, 2), (2, 4, 4, 2), (8, 1, 8, 1)]


@pytest.mark.parametrize("n_data,n_model,procs,local", LAYOUTS)
def test_hybrid_layout_matches_jax(monkeypatch, n_data, n_model, procs, local):
    """Which grids ``make_hybrid_mesh`` accepts: JAX's with its process
    count and local device count set (8 CPU devices in all), against
    ``hybrid_layout`` with as many hosts and local ranks; an accepted grid
    holds each ``model`` row inside one host."""
    monkeypatch.setattr(jax, "process_count", lambda: procs)
    monkeypatch.setattr(jax, "local_device_count", lambda: local)
    try:
        jmultihost.make_hybrid_mesh(n_data, n_model)
    except ValueError:
        with pytest.raises(ValueError):
            tmultihost.hybrid_layout(n_data, n_model, procs * local, local)
        return
    grid = tmultihost.hybrid_layout(n_data, n_model, procs * local, local)
    assert np.asarray(grid).shape == (n_data, n_model)
    for row in grid:
        assert len({r // local for r in row}) == 1


# -- the sharded step ------------------------------------------------------------

STEP_W = STEP_H = 32
# (mode, extra options): the first as tests/test_parallel.py's default-mode test
STEP_CASES = [("pre", {"opt.lambda_dssim": 0.2, "hidden.time_smoothness_weight": 1e-4}),
              ("replicated", {}), ("prim", {}), ("pre_prim", {})]


def _jax_cfg(name, extra):
    cfg = sp_cfg()
    cfg.tpu.shard_preprocess, cfg.tpu.shard_primitives = MODES[name]
    for k, v in extra.items():
        group, key = k.split(".")
        setattr(getattr(cfg, group), key, v)
    return cfg


@functools.cache
def _step_inputs():
    cfg = sp_cfg()
    state = build_state(cfg)
    cams, gts = make_batch(2, STEP_W, STEP_H)
    return state, cams, gts


@functools.cache
def _jax_step(name):
    extra = dict(STEP_CASES)[name]
    cfg = _jax_cfg(name, extra)
    state, cams, gts = _step_inputs()
    mesh = jmesh.make_mesh(2, 2)
    st = jtrainer.replicate(mesh, state)
    opt = jtrainer.replicate(mesh, jadam.init(state.params))
    if cfg.tpu.shard_primitives:
        st = st._replace(params=jtrainer.shard_primitives(mesh, st.params))
        opt = jtrainer.shard_adam(mesh, opt)
    c, g = jtrainer.place_batch(mesh, cams, gts)
    step = jtrainer.make_sharded_train_step(cfg, mesh, STEP_W, STEP_H, "fine",
                                            active_sh_degree=1, interpret=True)
    p, a, s, m = step(st.params, opt, st, c, g, 1)
    return jax.tree.map(np.asarray, (p, a, s, m))


@pytest.fixture(scope="module")
def port_steps(tmp_path_factory):
    """The port's step in every case, from one world of four ranks."""
    state, cams, gts = _step_inputs()
    cfg = tmultihost_cfg()
    state_np = interop.state_to_numpy(interop.state_from_jax(
        jax.tree.map(np.asarray, state), cfg, device="cpu"))
    cams_np = {k: np.asarray(getattr(cams, k)) for k in TR.CameraArrays._fields}
    res = run_ranks("tests.torch_parallel_ranks:sharded_step_modes", 4,
                    dict(cfg_overrides=SP_OVERRIDES, state_np=state_np, cams_np=cams_np,
                         gts_np=np.asarray(gts), width=STEP_W, height=STEP_H,
                         stage="fine", sh_degree=1, modes=STEP_CASES),
                    str(tmp_path_factory.mktemp("ranks")), timeout=300)
    return res


def tmultihost_cfg():
    from tests.torch_parallel_ranks import port_cfg

    return port_cfg(SP_OVERRIDES)


@pytest.mark.parametrize("name", [n for n, _ in STEP_CASES])
def test_sharded_step_matches_jax(port_steps, name):
    jp, ja, js, jm = _jax_step(name)
    got = port_steps[0][name]
    # every rank's whole state, parameters and moments, bit for bit
    assert len({r[name]["hash"] for r in port_steps}) == 1
    tm = got["metrics"]
    assert abs(tm["loss"] - float(jm["loss"])) < 1e-5
    assert abs(tm["l1"] - float(jm["l1"])) < 1e-5
    assert abs(tm["psnr"] - float(jm["psnr"])) < 1e-3
    for k in ("num_rendered", "max_tile_len", "n_points"):
        assert int(tm[k]) == int(jm[k]), k
    ts = got["state"]
    mu, nu, count = got["adam"]
    assert count == int(ja.count)
    # tests/test_parallel.py:146-176's tolerances: parameters rtol 2e-4,
    # atol 2e-6; the first moments rtol 2e-4, atol 5e-5
    for k in TG.PRIMITIVE_KEYS:
        np.testing.assert_allclose(ts.params[k], jp[k], rtol=2e-4, atol=2e-6,
                                   err_msg=f"{name}: param {k}")
        np.testing.assert_allclose(mu[k], ja.mu[k], rtol=2e-4, atol=5e-5,
                                   err_msg=f"{name}: mu {k}")
    for a, b in zip(jax.tree.leaves(ts.params["deform"]), jax.tree.leaves(jp["deform"])):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-6, err_msg=f"{name}: deform")
    for a, b in zip(jax.tree.leaves(mu["deform"]), jax.tree.leaves(ja.mu["deform"])):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=5e-5, err_msg=f"{name}: mu deform")
    np.testing.assert_allclose(ts.xyz_gradient_accum, js.xyz_gradient_accum,
                               rtol=2e-4, atol=1e-7)
    np.testing.assert_array_equal(ts.denom, js.denom)
    np.testing.assert_allclose(ts.max_radii2d, js.max_radii2d)
    np.testing.assert_allclose(ts.deformation_accum, js.deformation_accum,
                               rtol=2e-4, atol=1e-7)
