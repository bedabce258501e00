"""``bench_torch.py`` against ``bench.py`` at 64×64 on the CPU.

- ``build_workload``: the same cloud, colours, scale override, camera
  matrices and GT frame as ``bench.py::build_workload`` for the same seed
  and sizes (its GT render through the Pallas interpreter: ``bench.py``
  calls ``rasterize_pallas`` without ``interpret``, which only a TPU runs,
  so the test hands it the interpreted function);
- ``run``'s line has ``bench.py``'s keys, and the demand check fires when
  the instance budget is too small;
- ``chip_smoke.py``'s check of K1/K2 at the bench's last step, on the CPU
  (plain against plain): its blend inputs give the step's tile-space
  colour, and it returns both kernels' kernels-line fields.
"""

import functools

import numpy as np
import pytest

import bench
import bench_torch
from fourdgs_tpu.ops import rasterize as jrast
from tests.test_torch_math import warm_cpu_math  # noqa: F401  (autouse)
from tests.test_torch_cli import one_torch_thread  # noqa: F401  (autouse)

SMALL = dict(height=64, width=64, n_points=2000, capacity=4096)


def test_workload_matches_bench_py(monkeypatch):
    monkeypatch.setattr(jrast, "rasterize_pallas",
                        functools.partial(jrast.rasterize_pallas, interpret=True))
    _, jstate, _, jcams, jgts = bench.build_workload(**SMALL)
    w = bench_torch.build_workload(device="cpu", **SMALL)
    assert w.cfg.tpu.payload_bf16 and w.cfg.tpu.instance_budget == 384 * 1024
    n = SMALL["n_points"]
    # the cloud and colours: create_from_pcd's positions and DC band
    np.testing.assert_array_equal(w.state.params["xyz"][:n].numpy(),
                                  np.asarray(jstate.params["xyz"])[:n])
    np.testing.assert_allclose(w.state.params["f_dc"][:n].numpy(),
                               np.asarray(jstate.params["f_dc"])[:n], rtol=1e-6)
    np.testing.assert_array_equal(w.state.alive.numpy(), np.asarray(jstate.alive))
    # the scale override on every row (a float32 log: equal up to an ulp)
    np.testing.assert_allclose(w.state.params["scaling"].numpy(),
                               np.asarray(jstate.params["scaling"]), rtol=3e-7)
    for name in ("world_view", "full_proj", "camera_center", "tanfovx",
                 "tanfovy", "time"):
        np.testing.assert_array_equal(getattr(w.cams, name).numpy(),
                                      np.asarray(getattr(jcams, name)), err_msg=name)
    # the GT frame: K1's plain version against the interpreted Pallas
    # kernel on the same scene, within the association contract of
    # tests/test_pallas_raster.py (a pixel riding T_STOP may flip one
    # instance): colour within 1e-4 but for at most 0.1% of the values
    got, want = w.gts.numpy(), np.asarray(jgts)
    assert got.shape == want.shape == (1, 16, 5, 256)
    err = np.abs(got[:, :, :3] - want[:, :, :3])
    assert (err > 1e-4).mean() <= 1e-3 and err.max() < 1e-2, err.max()
    assert want[:, :, :3].max() > 0.5            # the balls are in view


def test_run_line_and_demand_check():
    line, info, _ = bench_torch.run(device="cpu", warmup=1, iters=2, **SMALL)
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert line["metric"] == "trained_pixels_per_s_per_chip"
    assert line["unit"] == "pixel/s" and line["value"] > 0
    np.testing.assert_allclose(line["vs_baseline"],
                               line["value"] / bench.BASELINE_PX_PER_S, atol=1e-4)
    assert bench_torch.BASELINE_PX_PER_S == bench.BASELINE_PX_PER_S
    assert info["steps"] == 2 and np.isfinite(info["loss"])
    assert 0 < info["max_num_rendered"] <= 384 * 1024
    with pytest.raises(AssertionError, match="budget overflow"):
        bench_torch.run(device="cpu", warmup=1, iters=1, instance_budget=1024, **SMALL)



def test_chip_smoke_bench_blend_check_on_cpu(monkeypatch):
    import torch

    import chip_smoke as CS
    from fourdgs_tpu_torch import scripts
    from fourdgs_tpu_torch.ops import blend
    from fourdgs_tpu_torch.render import CameraArrays, render

    monkeypatch.setattr(scripts, "ITERS", 1)
    monkeypatch.setattr(scripts, "REPS", 1)
    monkeypatch.setattr(scripts, "WARMUP", 1)
    # K2's batch is read from its built library on the card
    monkeypatch.setattr(blend, "k2_reduction",
                        lambda: {"batch": 3, "shuffles": 31, "unbatched": 50})
    _, _, w = bench_torch.run(device="cpu", warmup=1, iters=1, **SMALL)
    assert w.adam_state.count == 2           # the state after the last step
    dev = torch.device("cpu")
    cam = CameraArrays(*(x[0] for x in w.cams))
    bg = torch.ones(3) if w.cfg.model.white_background else torch.zeros(3)  # the step's
    fwd_args, bwd_args = CS.step_blend_inputs(w.cfg, w.state, cam, 64, 64, w.gts[0],
                                              bg, w.cfg.model.sh_degree, dev)
    with torch.no_grad():
        want = render(w.state.params, w.state, cam, w.cfg, 64, 64, "fine", bg,
                      w.cfg.model.sh_degree, device=dev, tile_space=True).color
    torch.testing.assert_close(bwd_args[5], want, rtol=0, atol=0)
    assert fwd_args[0].shape[1] >= 384 * 1024          # the bench's budget
    fields = CS.check_bench_blend(w, dev)
    for name in ("blend_forward", "blend_backward"):
        r = fields[name]
        assert r["max_abs_err"] == 0.0 and r["slots"] == fwd_args[0].shape[1]
        assert {"ms", "plain_ms", "bound_ms", "bound_by", "gated_share"} <= set(r)
