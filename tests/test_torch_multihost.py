"""The sharded trainer's schedule, CLI and scripts on the CPU, in worlds of
CPU gloo processes (``fourdgs_tpu_torch.parallel.launch``; each rank runs
with one thread, meets the others through a file store under the test's
temporary directory and is joined with a time limit):

- ``scene_reconstruction(mesh=2×2)`` against the port's single-device loop
  on ``tests/test_parallel.py::TestMeshMaintenanceCycle``'s schedule
  (densify, capacity growth 64 → 128 → 256, an opacity reset), with
  ``shard_primitives`` off and on: after 4 iterations the surgery's exact
  invariants and JAX's value tolerances, after 12 the structural ones, and
  every rank's state equal bit for bit;
- the collectives, ``multihost.initialize``'s contract;
- ``train_torch.py --mesh data=2,model=1 --distributed --device cpu`` on
  the 64×64 scene in two ranks: one checkpoint, which ``render_torch.py``
  renders; ``--mesh`` starting its own ranks (a failing rank stops the
  other and raises) and refusing a mesh larger than the host's GPUs;
- the scripts: ``multihost_smoke``'s two processes print equal losses,
  ``measure_scaling`` runs its slab loop at 64×64, ``measure_multihost``
  its gloo all-reduce.
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

import render_torch
import train_torch
from fourdgs_tpu_torch import interop
from fourdgs_tpu_torch.models import gaussians as TG
from fourdgs_tpu_torch.parallel import launch, multihost
from fourdgs_tpu_torch.parallel.launch import run_ranks
from fourdgs_tpu_torch.train import adam as tadam
from fourdgs_tpu_torch.train.loop import scene_reconstruction
from tests.test_data import make_dnerf_dataset
from tests.test_math_core import look_at_camera
from tests.test_torch_cli import OVERRIDES, frames_64, one_torch_thread  # noqa: F401
from tests.test_torch_math import warm_cpu_math  # noqa: F401  (autouse)
from tests.test_torch_parallel import SP_OVERRIDES
from tests.torch_parallel_ranks import port_cfg

# tests/test_parallel.py::TestMeshMaintenanceCycle's schedule
LOOP_OVERRIDES = {
    **SP_OVERRIDES, "tpu.capacity_init": 64, "opt.batch_size": 2,
    "opt.densify_from_iter": 2, "opt.densification_interval": 4,
    "opt.pruning_from_iter": 2, "opt.pruning_interval": 4,
    "opt.opacity_reset_interval": 8, "opt.densify_until_iter": 100,
    "opt.densify_grad_threshold_coarse": 1e-12, "opt.opacity_threshold_coarse": 0.004,
    "tpu.scan_steps": 1,
}
LOOP_RUNS = [(shard_prim, iters) for shard_prim in (False, True) for iters in (4, 12)]
LOOP_KW = dict(cameras_extent=3.0, rng_seed=11, log_interval=4)


@functools.cache
def _loop_scene():
    """``TestMeshMaintenanceCycle``'s four cameras and 48-point state."""
    W = H = 32
    rng = np.random.default_rng(3)
    cams = []
    for i in range(4):
        cam = look_at_camera([0.3 * i - 0.5, 0.2, -3], [0, 0, 0], width=W, height=H,
                             time=0.3 * i)
        cams.append((cam, rng.uniform(0, 1, (3, H, W)).astype(np.float32)))
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.7, 0.7, (48, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (48, 3)).astype(np.float32)
    state = TG.create_from_pcd(port_cfg(LOOP_OVERRIDES), pts, cols, 1.0, device="cpu")
    return cams, interop.state_to_numpy(state)


def _overrides(shard_prim):
    return {**LOOP_OVERRIDES, "tpu.shard_primitives": shard_prim}


@pytest.fixture(scope="module")
def mesh_loops(tmp_path_factory):
    """Every run of :data:`LOOP_RUNS` on one 2×2 world of four ranks."""
    cams, state_np = _loop_scene()
    res = run_ranks("tests.torch_parallel_ranks:loops_with_mesh", 4,
                    dict(runs=[(_overrides(p), n) for p, n in LOOP_RUNS],
                         state_np=state_np, cams_np=cams, **LOOP_KW),
                    str(tmp_path_factory.mktemp("ranks")), timeout=300)
    return {run: [r[i] for r in res] for i, run in enumerate(LOOP_RUNS)}


@pytest.mark.parametrize("shard_prim", [False, True])
@pytest.mark.parametrize("iters", [4, 12])
def test_sharded_loop_matches_single_device(mesh_loops, shard_prim, iters):
    cams, state_np = _loop_scene()
    cfg = port_cfg(_overrides(shard_prim))
    s0 = interop.state_from_jax(state_np, cfg, device="cpu")
    s1, a1, log1 = scene_reconstruction(cfg, s0, tadam.init(s0.params), cams, "coarse",
                                        iters, device="cpu", **LOOP_KW)
    ranks = mesh_loops[(shard_prim, iters)]
    assert len({r["hash"] for r in ranks}) == 1      # every rank's state, bit for bit
    got = ranks[0]
    sn, (mu, _, _) = got["state"], got["adam"]
    ref = interop.state_to_numpy(s1)
    mu1 = interop.adam_to_numpy(a1)[0]
    cap = {4: 128, 12: 256}[iters]
    assert ref.alive.shape[0] == sn.alive.shape[0] == cap     # growth fired
    np.testing.assert_array_equal(sn.alive, ref.alive)
    assert int(sn.alive.sum()) == int(ref.alive.sum()) > 48   # densify fired
    assert [r["n_points"] for r in got["log"]] == [r["n_points"] for r in log1.iterations]
    assert ([(e["iter"], e["kind"]) for e in got["events"]]
            == [(e["iter"], e["kind"]) for e in log1.events])
    if iters == 12:
        # past the reset, tests/test_parallel.py's phase 2: the structure
        # exactly (above), the values finite
        assert {"densify", "capacity", "reset"} <= {e["kind"] for e in got["events"]}
        for k in ("xyz", "opacity", "scaling"):
            assert np.isfinite(sn.params[k]).all(), k
        return
    # tests/test_parallel.py's phase 1 tolerances (rtol 5e-3, atol 5e-4) on
    # the moments, and on the parameters but where the gradient is zero to
    # float32 noise: a sum that cancels to exactly 0 on one device (measured:
    # rotation[46, 3] from the identity quaternion, iteration 3) leaves
    # ~1e-11 as four ranks' partial sums added in another order, and Adam
    # turns any nonzero gradient into a step of ±lr. Such elements (both
    # first moments within 1e-5 of the leaf's largest, chip_smoke.py's
    # GRAD_NOISE; that rotation element's are 2.3e-6 of it) may differ, at
    # most 1% of a leaf.
    for k in TG.PRIMITIVE_KEYS:
        np.testing.assert_allclose(mu[k], mu1[k], rtol=5e-3, atol=5e-4, err_msg=f"mu {k}")
        off = ~np.isclose(sn.params[k], ref.params[k], rtol=5e-3, atol=5e-4)
        floor = 1e-5 * np.abs(mu1[k]).max()
        noise = (np.abs(mu[k]) <= floor) & (np.abs(mu1[k]) <= floor)
        assert not (off & ~noise).any(), (k, np.argwhere(off & ~noise)[:5])
        assert off.sum() <= 0.01 * off.size, (k, int(off.sum()))


def test_collectives_on_two_ranks(tmp_path):
    res = run_ranks("tests.torch_parallel_ranks:collectives_check", 2, {}, str(tmp_path),
                    timeout=120)
    for r in res:
        counts = r.pop("counts")
        assert all(r.values()), r
        assert counts["all_gather"] == 2 and counts["reduce_scatter"] == 1


def test_initialize_contract(tmp_path):
    import torch.distributed as dist

    # explicit arguments are all or nothing, and fail loudly
    with pytest.raises(ValueError, match="together"):
        multihost.initialize(num_processes=1, process_id=0)
    assert not dist.is_initialized()
    assert multihost.initialize(f"file://{tmp_path}/store", 1, 0)
    try:
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        # idempotent: the open group is kept, whatever the arguments
        assert not multihost.initialize("127.0.0.1:1", 4, 3)
        mesh = multihost.make_hybrid_mesh(1, 1)
        assert (mesh.d, mesh.m, mesh.size) == (0, 0, 1)
        with pytest.raises(ValueError, match="need 2 ranks"):
            multihost.make_hybrid_mesh(2, 1)
        assert multihost.local_batch_slice(3, mesh) == slice(0, 3)
    finally:
        multihost.shutdown()
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def mesh_cli(tmp_path_factory, frames_64):
    """``train_torch.py --mesh data=2,model=1 --distributed --device cpu``
    in the two ranks of a CPU gloo world, then ``render_torch.py``."""
    data_dir = tmp_path_factory.mktemp("dnerf_mesh")
    make_dnerf_dataset(data_dir, n_train=6, n_test=2, size=64)
    model_path = str(tmp_path_factory.mktemp("out") / "mesh")
    argv = ["-s", str(data_dir), "--model_path", model_path, "--quiet",
            "--test_iterations", "6", "--save_iterations", "6",
            "--checkpoint_iterations", "6", "--mesh", "data=2,model=1", "--distributed",
            "--device", "cpu", "--override", *OVERRIDES]
    ranks = run_ranks("tests.torch_parallel_ranks:cli_rank", 2,
                      dict(argv=argv, target_size=(64, 64)),
                      str(tmp_path_factory.mktemp("ranks")), timeout=300)
    render_torch.main(["--model_path", model_path, "--source_path", str(data_dir),
                       "--skip_video", "--skip_train", "--device", "cpu"])
    return data_dir, model_path, ranks


def test_mesh_cli_writes_one_checkpoint_render_reads(mesh_cli):
    _, model_path, ranks = mesh_cli
    assert ranks[0]["hash"] == ranks[1]["hash"]
    assert sorted(d for d in os.listdir(model_path) if d.startswith("chkpnt_")) == [
        "chkpnt_fine_6"]
    for name in ("cfg_args.json", "training_logs.json", "timing_report.json",
                 "events.jsonl", "eval_log.jsonl"):
        assert os.path.exists(os.path.join(model_path, name)), name
    renders = os.path.join(model_path, "test", "ours_6", "renders")
    assert sorted(os.listdir(renders)) == ["00000.png", "00001.png"]


def test_mesh_cli_starts_its_ranks_and_stops_them(tmp_path):
    """Without ``--distributed`` a mesh of two starts two processes of the
    command; both fail on the missing scene, and the call raises with their
    output. A CUDA mesh asks for a GPU per rank first."""
    with pytest.raises(RuntimeError, match="could not recognize"):
        train_torch.main(["-s", "/nonexistent", "--mesh", "data=2", "--device", "cpu",
                          "--model_path", str(tmp_path / "m")])
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="needs 2 GPUs"):
            train_torch.main(["-s", "/nonexistent", "--mesh", "model=2", "--device", "cuda"])


def test_spawn_stops_every_rank_at_its_time_limit(tmp_path):
    sleeper = [sys.executable, "-c", "import time; time.sleep(60)"]
    with pytest.raises(RuntimeError, match="still running"):
        launch.spawn([sleeper, sleeper], 1.0, str(tmp_path))


def test_multihost_smoke_two_processes_agree(tmp_path):
    cmds = [[sys.executable, "-m", "fourdgs_tpu_torch.scripts.multihost_smoke", str(r),
             f"file://{tmp_path}/store", "--device", "cpu"] for r in range(2)]
    logs = launch.spawn(cmds, 180, str(tmp_path), cwd=launch.ROOT,
                        envs=[{"OMP_NUM_THREADS": "1"}] * 2)
    outs = []
    for path in logs:
        with open(path) as f:
            outs.append(f.read())
    both = "\n".join(f"--- rank {r} ---\n{out[-2000:]}" for r, out in enumerate(outs))
    losses = []
    for r, out in enumerate(outs):
        assert f"RANK {r} OK" in out, both
        losses.append(out.split("loss=")[-1].split()[0])
    assert losses[0] == losses[1]


def test_measure_scaling_slab_loop(monkeypatch):
    from fourdgs_tpu_torch import scripts
    from fourdgs_tpu_torch.scripts import measure_scaling

    for name in ("ITERS", "REPS", "WARMUP"):
        monkeypatch.setattr(scripts, name, 1)
    res = measure_scaling.run("cpu", size=64, shards=(1, 2, 4), n_points=1500,
                              capacity=2048)
    rows = res["slabs"]
    assert [r["tile_rows"] for r in rows] == [4, 2, 1]
    assert all(r["demand"] > 0 and r["budget"] >= r["demand"] for r in rows)
    assert rows[0]["demand"] >= rows[1]["demand"] >= rows[2]["demand"]
    assert res["full_step_ms"] > 0 and res["bandwidth"] == "assumed, not measured"
    assert measure_scaling.slab_budget(70_000) == 131_072


def test_measure_multihost_gloo(tmp_path):
    from fourdgs_tpu_torch.scripts import measure_multihost

    out = tmp_path / "mh.json"
    res = measure_multihost.main(["--device", "cpu", "--backends", "gloo,nccl",
                                  "--steps", "1", "--out", str(out)])
    runs = {(r["backend"], r["world"]): r for r in res["runs"]}
    assert runs[("gloo", 2)]["ranks_agree"] and runs[("gloo", 2)]["ms"] > 0
    assert "not_run" in runs[("nccl", 1)] and "not_run" in runs[("nccl", 2)]
    assert out.exists()


def test_sharded_step_does_not_sanitize_as_jax():
    """JAX's sharded step calls no ``sanitize_grads`` (its single-device
    step does, ``fourdgs_tpu/train/loop.py:183``); the port's sharded step
    does, after the gradient sum (a difference of the reference it no longer
    copies). A NaN in one grid-plane element makes the regularizer's
    gradient NaN on its neighbours: the single-device step and the sharded
    step (a 1×1 mesh of a one-rank world) both zero those gradients and
    leave only the poisoned element non-finite, and their parameters agree
    (within ``tests/test_parallel.py``'s rtol 2e-4, atol 2e-6) elsewhere;
    with ``tpu.sanitize_grads`` off, the sharded step spreads NaN, as
    JAX's does."""
    from fourdgs_tpu_torch.parallel import trainer
    from fourdgs_tpu_torch.parallel.mesh import make_mesh
    from fourdgs_tpu_torch.render import CameraArrays
    from fourdgs_tpu_torch.train.loop import make_train_step

    cams, state_np = _loop_scene()
    cfg = port_cfg({**SP_OVERRIDES, "hidden.time_smoothness_weight": 0.01})
    batch = CameraArrays(*(torch.stack(xs) for xs in zip(
        *(CameraArrays.from_camera(c, device="cpu") for c, _ in cams[:2]))))
    gts = torch.tensor(np.stack([g for _, g in cams[:2]]))

    def poisoned():
        st = interop.state_from_jax(state_np, cfg, device="cpu")
        with torch.no_grad():
            next(iter(st.params["deform"].grids.values())).view(-1)[0] = float("nan")
        return st

    def non_finite(params):
        return sum(int((~torch.isfinite(x)).sum()) for _, x in tadam.named_leaves(params))

    st = poisoned()
    with torch.enable_grad():
        p1, *_ = make_train_step(cfg, 32, 32, "fine", 1, device="cpu")(
            st.params, tadam.init(st.params), st, batch, gts, 1)
    assert multihost.initialize(backend="gloo")
    try:
        mesh = make_mesh(1, 1)
        sharded = {}
        for sanitize in (True, False):
            cfg.tpu.sanitize_grads = sanitize
            st = poisoned()
            c, g = trainer.place_batch(mesh, batch, gts)
            with torch.enable_grad():
                sharded[sanitize], *_ = trainer.make_sharded_train_step(
                    cfg, mesh, 32, 32, "fine", 1, device="cpu")(
                    st.params, tadam.init(st.params), st, c, g, 1)
    finally:
        multihost.shutdown()
    pn = sharded[True]
    assert non_finite(p1) == non_finite(pn) == 1
    assert non_finite(sharded[False]) > 1
    for (name, a), (_, b) in zip(tadam.named_leaves(p1), tadam.named_leaves(pn)):
        a, b = a.detach().numpy(), b.detach().numpy()
        finite = np.isfinite(a)
        np.testing.assert_array_equal(finite, np.isfinite(b), err_msg=name)
        np.testing.assert_allclose(b[finite], a[finite], rtol=2e-4, atol=2e-6, err_msg=name)
