"""The port's training schedule against the JAX package's under
``cfg.tpu.scan_steps`` > 1: ``fourdgs_tpu_torch.train.loop.
scene_reconstruction`` against ``fourdgs_tpu.train.loop.
scene_reconstruction`` (the Pallas kernels under the interpreter) on
``tests/test_torch_loop.py``'s scene, one coarse stage of 15 iterations.

JAX runs steps in chunks of at most ``scan_steps`` with no host gate
strictly inside one, as one scanned program, and reads a chunk's
``num_rendered`` and ``max_tile_len`` as their max over the chunk: the
budget gate and the log see those. Here every gate is a densify gate
(every 5 iterations, ``scan_steps`` 5, the log interval longer than the
run, the gates logged through ``extra_log_iters``), so JAX compiles one
scan program of 5 steps, and the budget grows once after that (a second
compile at the new budget).

The instance budget starts at 352, so the gate reads 0.7 · 352 = 246.4.
The chunk of iterations 6-10 peaks at 251 instances and ends at 243:
JAX grows the budget at iteration 10. The port before the chunk max read
the gate step's own 243, let the budget stand until iteration 15 (276
there) and dropped nothing meanwhile only because no step of this run
reaches 352; its logged ``num_rendered`` and ``max_tile_len`` were the
gate step's own. Held: each step's own values equal JAX's, at least one
gate's chunk max differs from its step's own value, the demand, the gate
of the growth and the budget after the stage equal JAX's (both packages'
``EventLog``), the logged metrics equal JAX's.

One JAX run per process serves every test that reads it; the file takes
about 70 s on one worker, most of it JAX compiling its scan program twice.
"""

import functools
import json
import os
import tempfile

import jax
import numpy as np
import pytest

from fourdgs_tpu.models import gaussians as JG
from fourdgs_tpu.train import adam as jadam
from fourdgs_tpu.train import loop as jloop
from fourdgs_tpu.utils.observability import EventLog as JaxEventLog
from fourdgs_tpu_torch import interop
from fourdgs_tpu_torch.train import adam as tadam
from fourdgs_tpu_torch.train import loop as tloop
from fourdgs_tpu_torch.utils.observability import EventLog
from tests import test_torch_loop as TL

ITERS, SCAN, BUDGET = 15, 5, 352
GATES = tuple(range(SCAN, ITERS + 1, SCAN))


def _scan_schedule(cfg):
    """``tests/test_torch_loop.py``'s schedule with gates every ``SCAN``
    iterations only and a fixed capacity, on either package's config."""
    cfg.tpu.scan_steps = SCAN
    cfg.tpu.instance_budget = BUDGET
    cfg.tpu.capacity = cfg.tpu.capacity_init = 64
    cfg.opt.densification_interval = cfg.opt.pruning_interval = SCAN
    cfg.opt.opacity_reset_interval = 1000
    return cfg


def _recorder(cfg, rows):
    def log_fn(it, stage, m, state, adam_state):
        rows.append({"iter": it, **m, "budget": cfg.tpu.instance_budget})
    return log_fn


def _budget_events(path):
    with open(os.path.join(path, "events.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["tag"].startswith("budget/")]


def _start():
    """JAX's config and init state from the scene's init cloud, the port's
    config and the same state, and the cameras."""
    gt, cams = TL._scene()
    pts, cols = TL._init_cloud(gt)
    jcfg = _scan_schedule(TL._jax_cfg())
    tcfg = _scan_schedule(TL._port_cfg())
    j0 = JG.create_from_pcd(jax.random.key(0), jcfg, pts, cols, 1.0)
    t0 = interop.state_from_jax(jax.tree.map(np.asarray, j0), tcfg, device="cpu")
    return jcfg, j0, tcfg, t0, cams


def _counting(make_step, record):
    """``make_step`` whose steps pass their metrics to ``record``."""
    def make(*args, **kw):
        step = make_step(*args, **kw)

        def run(*a):
            out = step(*a)
            record(out[3])
            return out
        return run
    return make


@functools.cache
def _runs():
    """JAX's coarse stage and the port's from the same init, each step's own
    ``num_rendered`` and ``max_tile_len`` recorded beside the loop (JAX's
    from its scan program's stacked metrics)."""
    jcfg, j0, tcfg, t0, cams = _start()
    jsteps, tsteps, jrows, trows = [], [], [], []
    keys = ("num_rendered", "max_tile_len")
    make_scan, make_step = jloop.make_train_scan, tloop.make_train_step

    logs = {"extra_log_iters": frozenset(GATES), "log_interval": 1000}
    jloop.make_train_scan = _counting(make_scan, lambda m: jsteps.extend(
        zip(*(np.asarray(m[k]).tolist() for k in keys))))
    tloop.make_train_step = _counting(make_step, lambda m: tsteps.append(
        tuple(int(m[k]) for k in keys)))
    try:
        with tempfile.TemporaryDirectory() as jdir, tempfile.TemporaryDirectory() as tdir:
            jloop.scene_reconstruction(
                jcfg, j0, jadam.init(j0.params), cams, "coarse", ITERS,
                cameras_extent=TL.EXTENT, log_fn=_recorder(jcfg, jrows),
                event_log=JaxEventLog(jdir), **logs)
            _, _, tlog = tloop.scene_reconstruction(
                tcfg, t0, tadam.init(t0.params), cams, "coarse", ITERS, TL.EXTENT,
                log_fn=_recorder(tcfg, trows), device="cpu",
                split_normals=TL.JaxNormals(6666), event_log=EventLog(tdir), **logs)
            jevents, tevents = _budget_events(jdir), _budget_events(tdir)
    finally:
        jloop.make_train_scan, tloop.make_train_step = make_scan, make_step
    return dict(jsteps=jsteps, tsteps=tsteps, jrows=jrows, trows=trows,
                jevents=jevents, tevents=tevents, events=tlog.events,
                budgets=(jcfg.tpu.instance_budget, tcfg.tpu.instance_budget))


def test_each_step_renders_as_in_jax():
    """Every step's own instance count and longest tile, the port's one
    step per call against JAX's scanned steps."""
    r = _runs()
    assert len(r["jsteps"]) == ITERS    # every step ran in a scan of SCAN
    assert r["tsteps"] == [tuple(s) for s in r["jsteps"]]


def test_gates_read_the_chunk_max():
    """At each gate both read the chunk's max, and at the growth gate the
    chunk max and the step's own value lie on either side of 70% of the
    budget: the gate step's own value would not have grown it."""
    r = _runs()
    assert [j["iter"] for j in r["jrows"]] == [t["iter"] for t in r["trows"]] == list(GATES)
    differs = []
    for g, j, t in zip(GATES, r["jrows"], r["trows"]):
        chunk = r["tsteps"][g - SCAN:g]
        peak = tuple(max(v) for v in zip(*chunk))
        assert (t["num_rendered"], t["max_tile_len"]) == peak, g
        assert (j["num_rendered"], j["max_tile_len"]) == peak, g
        differs.append(peak[0] != chunk[-1][0])
    assert any(differs)
    own, peak = r["tsteps"][9][0], max(n for n, _ in r["tsteps"][5:10])
    assert own <= 0.7 * BUDGET < peak


def test_budget_grows_at_the_same_gate():
    """The demand each growth read, its gate and the budget after it, from
    both packages' ``EventLog``, and the port's own event."""
    r = _runs()
    assert r["tevents"] == r["jevents"]
    growths = [e for e in r["events"] if e["kind"] == "budget"]
    assert [(e["iter"], e["budget"]) for e in growths] == [(10, 65536)]
    assert {"iter": 10, "tag": "budget/demand", "scalar": float(growths[0]["demand"])} \
        in r["jevents"]
    assert r["budgets"][0] == r["budgets"][1] == 65536
    assert [t["budget"] for t in r["trows"]] == [j["budget"] for j in r["jrows"]]


@pytest.mark.parametrize("key", ["n_points", "num_rendered", "max_tile_len"])
def test_logged_counts_match_jax(key):
    r = _runs()
    assert [t[key] for t in r["trows"]] == [j[key] for j in r["jrows"]]


@pytest.mark.parametrize("key", ["loss", "l1", "psnr"])
def test_logged_metrics_match_jax(key):
    r = _runs()
    for j, t in zip(r["jrows"], r["trows"]):
        np.testing.assert_allclose(t[key], j[key], rtol=1e-4, err_msg=f"{key} at {t['iter']}")


def test_no_chunks_without_the_device_cache():
    """``scan_steps`` on the streaming path (GT too large for the device
    cache) forms no chunk: the gate reads its step's own value, as JAX's
    loop does there, and here that is not the first chunk's max."""
    _, _, cfg, state, cams = _start()
    rows, own = [], []
    cap, make_step = tloop._GT_CACHE_CAP, tloop.make_train_step
    tloop._GT_CACHE_CAP = 0
    tloop.make_train_step = _counting(make_step,
                                      lambda m: own.append(int(m["num_rendered"])))
    try:
        tloop.scene_reconstruction(
            cfg, state, tadam.init(state.params), cams, "coarse", SCAN, TL.EXTENT,
            log_interval=1000, extra_log_iters=frozenset(GATES),
            log_fn=_recorder(cfg, rows), device="cpu", split_normals=TL.JaxNormals(6666))
    finally:
        tloop._GT_CACHE_CAP, tloop.make_train_step = cap, make_step
    assert [row["num_rendered"] for row in rows] == [own[-1]]
    assert own[-1] < max(own)
