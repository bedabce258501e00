"""The port's training schedule against the JAX package's:
``fourdgs_tpu_torch.train.loop.scene_reconstruction`` against
``fourdgs_tpu.train.loop.scene_reconstruction`` (the Pallas kernels under
the interpreter, ``scan_steps`` 1), coarse then fine.

The scene is ``tests/test_training.py``'s (48×48, 24 points, batch 2), the
init cloud its perturbed points. The schedule is shortened so that every
gate fires: 8 coarse iterations with densify and prune every 3 from
iteration 2 and an opacity reset at 6, in capacity 32 of at most 64 (it
grows at iteration 3) with an instance budget of 256 (it grows at
iteration 3 too); then 4 fine iterations, in both from JAX's carried
coarse state (``interop.state_from_jax``, Adam moments at the grown
capacity). JAX's split normals are injected (``split_normals``). Held:
the same gates at the same iterations with the same live counts, capacity
and budget; logged loss and PSNR within rtol 1e-4; the final state.

One JAX run per process (about 75 s under the interpreter, nearly all of
it compiling its three step programs) serves every test that reads it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs_tpu.models import gaussians as JG
from fourdgs_tpu.train import adam as jadam
from fourdgs_tpu.train import loop as jloop
from fourdgs_tpu.utils import forensics as jforensics
from fourdgs_tpu_torch import interop
from fourdgs_tpu_torch.configs.core import KPlanesConfig, load_config
from fourdgs_tpu_torch.train import adam as tadam
from fourdgs_tpu_torch.train import loop as tloop
from fourdgs_tpu_torch.utils.gradient_tracker import GradientTracker
from fourdgs_tpu_torch.viewer import NetworkGUI
from tests import test_training as TT

COARSE_ITERS, FINE_ITERS, EXTENT = 8, 4, 3.0


def _schedule(cfg):
    """The shortened schedule on either package's config."""
    cfg.tpu.capacity = 64
    cfg.tpu.capacity_init = 32
    cfg.tpu.instance_budget = 256
    cfg.tpu.backend = "pallas"
    cfg.tpu.scan_steps = 1
    cfg.opt.densify_from_iter = cfg.opt.pruning_from_iter = 2
    cfg.opt.densification_interval = cfg.opt.pruning_interval = 3
    cfg.opt.opacity_reset_interval = 6
    return cfg


def _jax_cfg():
    return _schedule(TT.tiny_cfg())


def _port_cfg():
    """``tests/test_training.py::tiny_cfg`` on the port's config."""
    cfg = load_config()
    cfg.tpu.tile_budget = 256
    cfg.tpu.blend_chunk = 64
    cfg.hidden.kplanes_config = KPlanesConfig(resolution=(8, 8, 8, 4),
                                              output_coordinate_dim=8)
    cfg.hidden.multires = (1,)
    cfg.hidden.net_width = 16
    cfg.hidden.defor_depth = 1
    cfg.model.sh_degree = 1
    cfg.model.white_background = False
    cfg.opt.batch_size = 2
    cfg.opt.densify_until_iter = 10000
    cfg.opt.position_lr_max_steps = 200
    return _schedule(cfg)


@functools.cache
def _scene():
    """``tests/test_training.py::make_gt_scene()``, made once per process."""
    return TT.make_gt_scene()


def _init_cloud(gt):
    rng = np.random.default_rng(1)
    pts = np.asarray(gt["means3d"]) + rng.normal(0, 0.05, (24, 3))
    return pts.astype(np.float32), np.full((24, 3), 0.5, np.float32)


class JaxNormals:
    """``split_normals`` for the port: the normals JAX's loop draws for its
    splits, ``normal(fold_in(sub, j), (cap, 3))`` with ``key, sub =
    split(key)`` at each densify from ``key(rng_seed)``."""

    def __init__(self, rng_seed):
        self.key = jax.random.key(rng_seed)

    def __call__(self, cap):
        self.key, sub = jax.random.split(self.key)
        return torch.stack([
            torch.tensor(np.asarray(
                jax.random.normal(jax.random.fold_in(sub, j), (cap, 3))))
            for j in range(2)])


def _recorder(cfg, rows, alive_sum):
    def log_fn(it, stage, m, state, adam_state):
        rows.append({"iter": it, "stage": stage, **m,
                     "alive": int(alive_sum(state.alive)),
                     "capacity": int(state.alive.shape[0]),
                     "budget": cfg.tpu.instance_budget})
    return log_fn


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.cache
def _runs():
    """JAX's coarse and fine stages, and the port's coarse stage from the
    same init and its fine stage from JAX's coarse state."""
    gt, cams = _scene()
    pts, cols = _init_cloud(gt)
    jcfg = _jax_cfg()
    j0 = JG.create_from_pcd(jax.random.key(0), jcfg, pts, cols, 1.0)
    jrows = []
    jlog = _recorder(jcfg, jrows, np.sum)
    jc, jca, _ = jloop.scene_reconstruction(
        jcfg, j0, jadam.init(j0.params), cams, "coarse", COARSE_ITERS,
        cameras_extent=EXTENT, log_interval=1, log_fn=jlog)
    jf, jfa, _ = jloop.scene_reconstruction(
        jcfg, jc, jca, cams, "fine", FINE_ITERS, cameras_extent=EXTENT,
        rng_seed=6667, log_interval=1, log_fn=jlog)

    tcfg = _port_cfg()
    trows = []
    tlog = _recorder(tcfg, trows, torch.sum)
    t0 = interop.state_from_jax(_np(j0), tcfg, device="cpu")
    tc, tca, tclog = tloop.scene_reconstruction(
        tcfg, t0, tadam.init(t0.params), cams, "coarse", COARSE_ITERS, EXTENT,
        log_interval=1, log_fn=tlog, device="cpu", split_normals=JaxNormals(6666))
    assert tcfg.tpu.instance_budget == jcfg.tpu.instance_budget
    tf0 = interop.state_from_jax(_np(jc), tcfg, device="cpu")
    tf0a = interop.adam_from_jax_numpy(_np(jca.mu), _np(jca.nu), int(jca.count),
                                       tf0.params)
    tf, tfa, tflog = tloop.scene_reconstruction(
        tcfg, tf0, tf0a, cams, "fine", FINE_ITERS, EXTENT, rng_seed=6667,
        log_interval=1, log_fn=tlog, device="cpu", split_normals=JaxNormals(6667))
    return dict(jrows=jrows, trows=trows, jc=jc, jca=jca, jf=jf, jfa=jfa,
                tc=tc, tca=tca, tf=tf, tfa=tfa, events=tclog.events + tflog.events)


def test_gates_fire_as_in_jax():
    r = _runs()
    assert len(r["jrows"]) == len(r["trows"]) == COARSE_ITERS + FINE_ITERS
    for j, t in zip(r["jrows"], r["trows"]):
        where = f"{t['stage']} {t['iter']}"
        assert (t["iter"], t["stage"]) == (j["iter"], j["stage"])
        for k in ("alive", "capacity", "budget", "n_points", "num_rendered",
                  "max_tile_len"):
            assert t[k] == j[k], f"{k} at {where}"
    kinds = [(e["stage"], e["iter"], e["kind"]) for e in r["events"]]
    for gate in (("coarse", 3, "capacity"), ("coarse", 3, "budget"),
                 ("coarse", 3, "densify"), ("coarse", 6, "reset")):
        assert gate in kinds, kinds
    assert any(e["kind"] == "densify" and e["split"] > 0 for e in r["events"])


def test_logged_metrics_match_jax():
    r = _runs()
    for j, t in zip(r["jrows"], r["trows"]):
        for k in ("loss", "l1", "psnr"):
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4,
                                       err_msg=f"{k} at {t['stage']} {t['iter']}")


@pytest.mark.parametrize("stage", ["coarse", "fine"])
def test_final_state_matches_jax(stage):
    """Alive, table and capacity exactly; each parameter and moment leaf
    within rtol 1e-4 plus 1e-4 of the leaf's largest |value| (the float32
    noise of 8 carried steps of a float32 step that agrees to rtol 1e-5,
    ``tests/test_torch_train.py``)."""
    r = _runs()
    j, ja, t, ta = ((r["jc"], r["jca"], r["tc"], r["tca"]) if stage == "coarse"
                    else (r["jf"], r["jfa"], r["tf"], r["tfa"]))
    got = interop.state_to_numpy(t)
    np.testing.assert_array_equal(got.alive, np.asarray(j.alive))
    np.testing.assert_array_equal(got.deformation_table,
                                  np.asarray(j.deformation_table))
    assert got.active_sh_degree == int(j.active_sh_degree)
    mu, nu, count = interop.adam_to_numpy(ta)
    assert count == int(ja.count)
    for what, g_tree, w_tree in (("params", got.params, j.params),
                                 ("mu", mu, ja.mu), ("nu", nu, ja.nu)):
        w_tree = _np(w_tree)
        assert jax.tree.structure(g_tree) == jax.tree.structure(w_tree)
        paths = [jax.tree_util.keystr(p) for p, _ in
                 jax.tree_util.tree_flatten_with_path(w_tree)[0]]
        for path, g, w in zip(paths, jax.tree.leaves(g_tree), jax.tree.leaves(w_tree)):
            scale = float(np.abs(w).max()) if w.size else 0.0
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * scale + 1e-30,
                                       err_msg=f"{stage} {what}{path}")
    for k in ("max_radii2d", "denom"):
        np.testing.assert_array_equal(getattr(got, k), np.asarray(getattr(j, k)), err_msg=k)


def _port_start(cfg, gt_images=None):
    """The tiny scene's cameras (GT replaced by ``gt_images``) and a port
    state from its init cloud, on the CPU."""
    gt, cams = _scene()
    if gt_images is not None:
        cams = [(c, g) for (c, _), g in zip(cams, gt_images)]
    pts, cols = _init_cloud(gt)
    state = tloop.G.create_from_pcd(cfg, pts, cols, 1.0, device="cpu")
    return cams, state, tadam.init(state.params)


def test_nan_loss_dumps_a_snapshot_with_jax_keys(tmp_path):
    """A poisoned GT makes the loss NaN: the watchdog writes a snapshot
    whose keys and shapes are those JAX's ``dump_snapshot`` writes for the
    same state, camera batch, metrics and extras, then raises."""
    cfg = _port_cfg()
    poisoned = [np.full((3, 48, 48), np.nan, np.float32)] * 8
    cams, state, opt = _port_start(cfg, poisoned)
    with pytest.raises(FloatingPointError, match="NaN at coarse iteration 1"):
        tloop.scene_reconstruction(cfg, state, opt, cams, "coarse", 3, EXTENT,
                                   log_interval=1, model_path=str(tmp_path),
                                   device="cpu")
    (path,) = tmp_path.glob("snapshot_nan_coarse_1_*.npz")
    with np.load(path, allow_pickle=False) as got:
        got = {k: got[k].shape for k in got.files}

    jcfg = _jax_cfg()
    pts, cols = _init_cloud(_scene()[0])
    js = JG.create_from_pcd(jax.random.key(0), jcfg, pts, cols, 1.0)
    jcams = jax.tree.map(lambda *xs: jnp.stack(xs),
                         *[jloop.CameraArrays.from_camera(c) for c, _ in cams[:2]])
    names = ("l1", "loss", "max_tile_len", "n_points", "num_rendered", "psnr")
    want_path = jforensics.dump_snapshot(
        str(tmp_path / "jax"), "nan_coarse_1", js.params, state=js, cams=jcams,
        metrics={k: 0.0 for k in names},
        extra={"iteration": 1, "instance_budget": 256, "capacity": 32,
               "batch_idx": np.zeros(2, np.int64)})
    with np.load(want_path, allow_pickle=False) as want:
        want = {k: want[k].shape for k in want.files}
    assert got == want
    assert float(np.load(path)["metrics.n_points"]) == 24


@pytest.mark.parametrize("option", ["mesh", "viewer", "gradient_tracker",
                                    "debug_mode", "render_process", "lazy_gt",
                                    "lambda_dssim", "isotropic"])
def test_unported_options_raise(option, tmp_path):
    cfg = _port_cfg()
    cams, state, opt = _port_start(cfg)
    kw = {"model_path": str(tmp_path)}
    if option == "mesh":
        # ported now (tests/test_torch_parallel.py, tests/test_torch_multihost.py):
        # a 1×1 mesh on a one-rank CPU gloo world trains as the run without one
        _one_rank_mesh_matches_single_device(cfg, cams)
        return
    if option == "debug_mode":
        kw[option] = True
    elif option == "viewer":
        kw[option] = NetworkGUI(port=0)      # no viewer connects
    elif option == "gradient_tracker":
        kw[option] = GradientTracker(str(tmp_path), record_interval=1)
    elif option == "render_process":
        cfg.model.render_process = True
    elif option == "lazy_gt":
        cams = [(c, _LazyFrame(g)) for c, g in cams]
    elif option == "lambda_dssim":
        cfg.opt.lambda_dssim = 0.2
    else:
        cfg.model.use_isotropic_gaussian = True
    if option in ("lazy_gt", "isotropic", "debug_mode", "render_process", "viewer",
                  "gradient_tracker", "lambda_dssim"):
        # ported now (tests/test_torch_lazy.py, tests/test_torch_isotropic.py,
        # tests/test_torch_debug_images.py, tests/test_torch_viewer.py,
        # tests/test_torch_gradient_tracker.py and tests/test_torch_dssim.py
        # hold them against arrays and JAX): they no longer raise
        try:
            _, _, log = tloop.scene_reconstruction(cfg, state, opt, cams, "coarse", 1,
                                                   EXTENT, device="cpu", **kw)
        finally:
            if option == "viewer":
                kw["viewer"].close()
        assert np.isfinite(log.iterations[-1]["loss"])
        if option == "gradient_tracker":
            assert kw[option].iterations == [1] and "xyz/norm" in kw[option].history
        return
    with pytest.raises(NotImplementedError):
        tloop.scene_reconstruction(cfg, state, opt, cams, "coarse", 1, EXTENT,
                                   device="cpu", **kw)


def _one_rank_mesh_matches_single_device(cfg, cams):
    """The coarse stage on a 1×1 mesh of a one-rank CPU gloo world against
    the same stage without a mesh. Through iteration 3 (the first densify,
    capacity growth and budget growth included): equal alive sets and point
    counts, the parameters and first moments within
    ``tests/test_parallel.py:146-176``'s tolerances (rtol 2e-4; atol 2e-6
    and 5e-5). The whole schedule (densify, prune, capacity growth, opacity
    reset): the same gates, counts and alive sets; the values part from
    iteration 4 on, because the slab's rect clip bins the Gaussians the
    densify left dead (JAX's ``rasterize.py:314-319``, copied; ROADMAP
    Queue 3; ``tests/test_torch_parallel.py::test_slab_clip_renders_dead_gaussians_as_jax``),
    so the sharded step renders them and the single-device step does not.
    Its mark: after the opacity reset zeroes every opacity moment, the dead
    rows' opacity moments stay 0 without the mesh and move under it."""
    from fourdgs_tpu_torch.parallel import multihost
    from fourdgs_tpu_torch.parallel.mesh import make_mesh

    def run(mesh, iters):
        c = _port_cfg()
        _, state, opt = _port_start(c)
        return tloop.scene_reconstruction(c, state, opt, cams, "coarse", iters, EXTENT,
                                          device="cpu", mesh=mesh, log_interval=1)

    single = [run(None, n) for n in (3, COARSE_ITERS)]
    assert multihost.initialize(backend="gloo")
    try:
        mesh = make_mesh(1, 1)
        meshed = [run(mesh, n) for n in (3, COARSE_ITERS)]
    finally:
        multihost.shutdown()
    for (s1, a1, log1), (sm, am, logm) in zip(single, meshed):
        np.testing.assert_array_equal(sm.alive.numpy(), s1.alive.numpy())
        assert ([r["n_points"] for r in logm.iterations]
                == [r["n_points"] for r in log1.iterations])
        # the gates at the same iterations (a slab's demand also counts the
        # rects of dead and culled Gaussians, as JAX's rect clip does, so the
        # budget events carry other demands)
        assert ([(e["iter"], e["kind"]) for e in logm.events]
                == [(e["iter"], e["kind"]) for e in log1.events])
    assert {"densify", "capacity", "budget"} <= {e["kind"] for e in single[0][2].events}
    assert {"densify", "capacity", "reset"} <= {e["kind"] for e in single[1][2].events}
    (s1, a1, _), (sm, am, _) = single[0], meshed[0]
    for k in tloop.G.PRIMITIVE_KEYS:
        np.testing.assert_allclose(sm.params[k].detach().numpy(),
                                   s1.params[k].detach().numpy(), rtol=2e-4, atol=2e-6,
                                   err_msg=k)
        np.testing.assert_allclose(am.mu[k].numpy(), a1.mu[k].numpy(), rtol=2e-4,
                                   atol=5e-5, err_msg=k)
    (s1, a1, _), (sm, am, _) = single[1], meshed[1]
    dead = ~s1.alive.numpy()
    assert dead.any()
    assert not a1.mu["opacity"].numpy()[dead].any()
    assert am.mu["opacity"].numpy()[dead].any()


class _LazyFrame:
    """A GT frame the loop calls, with the ``shape`` and ``ndim`` it reads
    (``data/dynerf.py::ImageRef``'s interface, without a path)."""

    def __init__(self, img):
        self.img, self.shape, self.ndim = img, img.shape, img.ndim

    def __call__(self):
        return self.img


def test_any_timer_with_detailed_timers_methods():
    """The timer is duck-typed, as in JAX: an object with
    ``DetailedTimer``'s methods times each iteration's phases."""
    cfg = _port_cfg()
    cams, state, opt = _port_start(cfg)
    calls = []

    class Recorder:
        def __getattr__(self, name):
            return lambda *args, **kw: calls.append((name, *args))

    tloop.scene_reconstruction(cfg, state, opt, cams, "coarse", 2, EXTENT,
                               log_interval=1, timer=Recorder(), device="cpu")
    names = [c[0] for c in calls]
    assert names.count("start_iteration") == names.count("end_iteration") == 2
    assert ("start_timer", "coarse_render") in calls
    assert ("end_iteration", 2, "coarse") in calls
    assert names.count("start_timer") == names.count("end_timer")


def test_samplers_match_jax():
    import random

    from fourdgs_tpu.data import samplers as js
    from fourdgs_tpu_torch.data import samplers as ts

    for n_cams, n_poses in ((40, 4), (30, 6)):
        a, b = random.Random(3), random.Random(3)
        for _ in range(3):
            assert (ts.fine_sampler_order(n_cams, n_poses, a)
                    == js.fine_sampler_order(n_cams, n_poses, b))
        assert ts.get_stamp_list(n_cams, n_poses, 2) == js.get_stamp_list(n_cams, n_poses, 2)
