"""``bench_quality_torch.py``, the port's quality bench, against
``bench_quality.py``: the synthetic scene, its GT attributes and the ring
cameras equal the JAX script's; the oracle loader reads
``gt_cache/oracle_gt_800_100_10.npz`` with the cameras rebuilt from its
metadata; and a 64×64 CPU run (GT from the port's rasterizer, a few
iterations per stage with every gate firing, the deformation cut to a tiny
grid and width so the CPU run stays short) prints one JSON line with
``bench_quality.py``'s keys and the port's counts."""

import json
import pathlib

import numpy as np
import pytest

import bench_quality as JB
import bench_quality_torch as TB
from fourdgs_tpu_torch.configs.core import KPlanesConfig
from tests.test_torch_cli import one_torch_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CAMERA_FIELDS = ("world_view", "full_proj", "camera_center", "tanfovx",
                 "tanfovy", "time", "width", "height")


def _same_camera(got, want):
    for f in CAMERA_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)), err_msg=f)


def test_gt_scene_matches_jax_bench():
    got, want = TB.make_gt_scene(), JB.make_gt_scene()
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    for t in (0.0, 0.37, 1.0):
        np.testing.assert_array_equal(got[3](t), want[3](t))
    g_args, w_args = TB.gt_raster_args(*got[:3]), JB.gt_raster_args(*want[:3])
    assert g_args.keys() == w_args.keys()
    for k in g_args:
        np.testing.assert_array_equal(g_args[k], np.asarray(w_args[k]), err_msg=k)


@pytest.mark.parametrize("ang,elev,t", [(0.0, 0.15, 0.0), (2.3, 0.6, 0.5),
                                        (5.9, 0.9, 1.0)])
def test_ring_camera_matches_jax_bench(ang, elev, t):
    _same_camera(TB.ring_camera(ang, elev, 800, 800, t),
                 JB.ring_camera(ang, elev, 800, 800, t))


def test_oracle_loader_reads_the_cache():
    train, test = TB.load_oracle(800, 100, 10)
    assert len(train) == 100 and len(test) == 10
    with np.load(TB.oracle_path(800, 100, 10)) as data:
        np.testing.assert_array_equal(test[3][1], data["test_imgs"][3])
        a, e, t = data["train_meta"][7]
    cam, img = train[7]
    assert img.dtype == np.uint8 and img.shape == (800, 800, 3)
    _same_camera(cam, JB.ring_camera(float(a), float(e), 800, 800, float(t)))
    with pytest.raises(FileNotFoundError):
        TB.load_oracle(64, 4, 2)


def test_cpu_run_prints_every_key(monkeypatch, capsys, tmp_path):
    configure = TB.configure

    def short(cfg, scale):
        configure(cfg, scale)
        cfg.opt.coarse_iterations = cfg.opt.iterations = 4
        cfg.opt.densify_from_iter = cfg.opt.pruning_from_iter = 1
        cfg.opt.densification_interval = cfg.opt.pruning_interval = 2
        cfg.opt.opacity_reset_interval = 3
        cfg.tpu.capacity_init = 2048
        cfg.hidden.kplanes_config = KPlanesConfig(resolution=(8, 8, 8, 4),
                                                  output_coordinate_dim=8)
        cfg.hidden.multires = (1,)
        cfg.hidden.net_width = 16

    monkeypatch.setattr(TB, "configure", short)
    out = tmp_path / "bench.json"
    TB.main(["--size", "64", "--n_train", "4", "--n_test", "2", "--device", "cpu",
             "--log_interval", "1", "--out", str(out)])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    res = json.loads(line)
    assert json.loads(out.read_text()) == res
    jax_keys = set(json.loads((ROOT / "BENCH_QUALITY_ORACLE.json").read_text()))
    assert jax_keys - set(res) == {"chip_minutes_vs_host_budget"}
    port_keys = {"device", "payload", "k1_launches", "k2_launches", "budget_growths",
                 "final_instance_budget", "capacity_growths", "final_capacity",
                 "densify_events", "growth_events", "last_train_psnr", "stage_s"}
    assert port_keys <= set(res)
    assert res["backend"] == res["device"] == "cpu" and res["payload"] == "bf16"
    assert res["schedule"] == {"coarse": 4, "fine": 4}
    assert np.isfinite(res["test_psnr_db"]) and len(res["test_psnrs_db"]) == 2
    assert res["capacity_growths"] >= 1 and res["final_capacity"] > 2048
    assert res["resets"] == 2 and res["final_points"] > 2000
    assert all(e["kind"] in ("densify", "prune") for e in res["densify_events"])
    kinds = [e["kind"] for e in res["growth_events"]]
    assert (kinds.count("capacity"), kinds.count("budget")) == (
        res["capacity_growths"], res["budget_growths"])
    # the plain blend runs on the CPU: no kernel launch is counted
    assert res["k1_launches"] == res["k2_launches"] == 0


def _tiny(cfg):
    """A few iterations per stage on a tiny deformation grid (CPU-sized)."""
    cfg.opt.coarse_iterations = cfg.opt.iterations = 3
    cfg.tpu.capacity_init = 2048
    cfg.hidden.kplanes_config = KPlanesConfig(resolution=(8, 8, 8, 4),
                                              output_coordinate_dim=8)
    cfg.hidden.multires = (1,)
    cfg.hidden.net_width = 16


def test_trained_model_blend_check_on_cpu(monkeypatch):
    """``chip_smoke.py``'s check of K1/K2 on the trained model of phase 9
    (a), on the CPU after a tiny run, where both sides are the plain
    versions: its blend inputs are those of the train step's render of the
    view (the same tile-space colour), its cotangent is the step's L1
    cotangent, and it returns the kernels-line fields of both kernels."""
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
    res, model = TB.run(size=64, n_train=3, n_test=1, device="cpu", adjust=_tiny,
                        log_interval=100)
    assert model.state.alive.shape[0] == res["final_capacity"]
    assert model.cfg.tpu.instance_budget == res["final_instance_budget"]
    dev = torch.device("cpu")
    fwd_args, bwd_args = CS.view_blend_inputs(model, 1, dev)
    cam, frame = model.train_cams[1]
    st = model.state
    with torch.no_grad():
        want = render(st.params, st, CameraArrays.from_camera(cam, device=dev),
                      model.cfg, 64, 64, "fine", model.bg, st.active_sh_degree,
                      device=dev, tile_space=True).color
    out5, g_out = bwd_args[5], bwd_args[6]
    torch.testing.assert_close(out5, want, rtol=0, atol=0)
    assert bwd_args[:5] == fwd_args[:5] and bwd_args[7] == fwd_args[5]
    # the L1's cotangent: ±1 / (B·3·H·W) on the colour rows, 0 on depth and T
    unit = torch.tensor(1.0 / (model.cfg.opt.batch_size * 3 * 64 * 64)).item()
    assert set(g_out[:, :3].abs().unique().tolist()) == {unit}
    assert bool((g_out[:, 3:] == 0).all())
    fields = CS.check_trained_blend(model, dev)
    for name in ("blend_forward", "blend_backward"):
        r = fields[name]
        assert r["max_abs_err"] == 0.0 and r["slots"] == fwd_args[0].shape[1]
        assert {"ms", "plain_ms", "bound_ms", "bound_by", "gated_share"} <= set(r)


def test_card_maintenance_check_on_cpu():
    """``chip_smoke.py``'s phase 9 (c) with both sides on the CPU: clone,
    split and prune fire, and every element passes its operand bound."""
    import torch

    import chip_smoke as CS

    res = CS.check_maintenance_on_card(torch.device("cpu"))
    assert res["cloned"] > 0 and res["split"] > 0 and res["pruned"] > 0
    assert res["max_abs_err"] == 0.0
