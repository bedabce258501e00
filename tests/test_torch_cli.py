"""The port's CLI chain on the CPU: ``train_torch.py`` → ``render_torch.py``
→ ``metrics_torch.py`` with ``--device cpu`` on a fabricated 64×64 D-NeRF
scene (the loader's frame size set to 64×64: it resizes to JAX's 800×800
otherwise), with ``tests/test_cli.py``'s
overrides but the ``pallas`` backend:
the outputs of ``test_cli.py::test_outputs_exist`` exist, the renders equal
``fourdgs_tpu.render.render`` (the Pallas interpreter) of the same snapshot
within one level of 255, the metrics are written with null LPIPS, a
checkpoint resumes, and the flags of paths not ported raise."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_torch
import render_torch
import train_torch
from fourdgs_tpu import render as JR
from fourdgs_tpu.configs.core import config_from_dict
from fourdgs_tpu.train import checkpoint as jckpt
from fourdgs_tpu_torch.configs.core import load_config as tload
from fourdgs_tpu_torch.data import scene as tscene
from fourdgs_tpu_torch.data.scene import load_scene
from fourdgs_tpu_torch.utils import png
from tests.test_data import make_dnerf_dataset
from tests.test_torch_math import warm_cpu_math  # noqa: F401  (autouse)

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module's CPU training: under the
    6-worker tier-1 run, PyTorch's default pool (one thread per core in
    every worker) spends most of a small op waiting for busy cores (the
    64×64 training ran ~6× slower with all cores loaded)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def frames_64():
    """The loader's frame size for the module's 64×64 scenes."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tscene, "TARGET_SIZE", (64, 64))
        yield


OVERRIDES = [
    "opt.iterations=6", "opt.coarse_iterations=4",
    "opt.densify_from_iter=1000", "opt.pruning_from_iter=1000",
    "tpu.capacity=4096", "tpu.instance_budget=16384",
    "tpu.tile_budget=256", "tpu.blend_chunk=64",
    'tpu.backend="pallas"',
    "hidden.net_width=16", "hidden.defor_depth=0",
    "hidden.multires=[1]",
    'hidden.kplanes_config={"grid_dimensions": 2, "input_coordinate_dim": 4, '
    '"output_coordinate_dim": 8, "resolution": [8, 8, 8, 4]}',
]


@pytest.fixture(scope="module")
def trained_model(tmp_path_factory, frames_64):
    data_dir = tmp_path_factory.mktemp("dnerf_data")
    make_dnerf_dataset(data_dir, n_train=6, n_test=2, size=64)
    model_path = str(tmp_path_factory.mktemp("out") / "smoke")
    train_torch.main([
        "-s", str(data_dir), "--model_path", model_path, "--quiet",
        "--test_iterations", "6", "--save_iterations", "6",
        "--checkpoint_iterations", "6", "--device", "cpu",
        "--override", *OVERRIDES,
    ])
    render_torch.main(["--model_path", model_path, "--source_path", str(data_dir),
                       "--skip_video", "--skip_train", "--device", "cpu"])
    metrics_torch.main(["--model_path", model_path, "--device", "cpu"])
    return str(data_dir), model_path


def test_outputs_exist(trained_model):
    _, model_path = trained_model
    for name in ("cfg_args.json", "timing_report.json", "training_logs.json",
                 "eval_log.jsonl", "events.jsonl"):
        assert os.path.exists(os.path.join(model_path, name)), name
    assert os.listdir(os.path.join(model_path, "eval_images"))
    snap = os.path.join(model_path, "point_cloud", "iteration_6")
    assert os.path.exists(os.path.join(snap, "point_cloud.ply"))
    assert os.path.exists(os.path.join(snap, "deformation.npz"))
    assert any(d.startswith("chkpnt_fine_") for d in os.listdir(model_path))
    with open(os.path.join(model_path, "training_logs.json")) as f:
        logs = json.load(f)
    assert logs and np.isfinite(logs[-1]["loss"])
    assert [r["stage"] for r in logs] == ["coarse", "fine"]
    with open(os.path.join(model_path, "timing_report.json")) as f:
        report = json.load(f)
    assert {"fine_render", "fine_data_loading", "fine_densification",
            "fine_logging"} <= set(report["summary"]["operations"])
    with open(os.path.join(model_path, "eval_log.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert rows and np.isfinite(rows[-1]["test"]["psnr"])


def test_renders_match_jax(trained_model):
    data_dir, model_path = trained_model
    with open(os.path.join(model_path, "cfg_args.json")) as f:
        jcfg = config_from_dict(json.load(f))
    snap = os.path.join(model_path, "point_cloud", "iteration_6")
    jstate = jckpt.load_snapshot(snap, jcfg, jax.random.key(0))
    bg = jnp.ones(3) if jcfg.model.white_background else jnp.zeros(3)
    cams = [lc.camera for lc in load_scene(tload(), data_dir).test_cameras]
    rdir = os.path.join(model_path, "test", "ours_6", "renders")
    assert sorted(os.listdir(rdir)) == ["00000.png", "00001.png"]

    @jax.jit
    def jax_render(params, cam):
        return JR.render(params, jstate, cam, jcfg, 64, 64, "fine", bg,
                         jcfg.model.sh_degree, backend="pallas").color

    for i, cam in enumerate(cams):
        want = np.asarray(jax_render(jstate.params, JR.CameraArrays.from_camera(cam)))
        want8 = (np.clip(want.transpose(1, 2, 0), 0, 1) * 255).astype(np.uint8)
        got8 = png.read_png(os.path.join(rdir, f"{i:05d}.png"))
        assert got8.shape == want8.shape == (64, 64, 3)
        # float32 renders within 1e-4 of each other can round to uint8
        # on either side of a level
        assert np.abs(got8.astype(int) - want8.astype(int)).max() <= 1
        assert (got8 != want8).mean() < 0.01
        gt = png.read_png(os.path.join(model_path, "test", "ours_6", "gt", f"{i:05d}.png"))
        assert gt.shape == (64, 64, 3)


def test_metrics_written(trained_model):
    _, model_path = trained_model
    with open(os.path.join(model_path, "results.json")) as f:
        vals = json.load(f)["ours_6"]
    assert np.isfinite(vals["PSNR"]) and np.isfinite(vals["MS-SSIM"])
    assert np.isfinite(vals["SSIM"]) and vals["D-SSIM"] == pytest.approx(
        (1 - vals["MS-SSIM"]) / 2)
    assert vals["LPIPS-vgg"] is None and vals["LPIPS-alex"] is None
    with open(os.path.join(model_path, "per_view.json")) as f:
        assert len(json.load(f)["ours_6"]["PSNR"]) == 2


def test_resume_from_checkpoint(trained_model):
    data_dir, model_path = trained_model
    state, _ = train_torch.main([
        "-s", data_dir, "--model_path", model_path + "_resumed", "--quiet",
        "--start_checkpoint", os.path.join(model_path, "chkpnt_fine_6"),
        "--test_iterations", "-1", "--save_iterations", "-1", "--device", "cpu",
        "--override", *[o.replace("opt.iterations=6", "opt.iterations=8")
                        for o in OVERRIDES],
    ])
    with open(os.path.join(model_path + "_resumed", "training_logs.json")) as f:
        logs = json.load(f)
    assert [r["stage"] for r in logs] == ["fine"]    # a fine checkpoint skips coarse
    assert logs[-1]["iteration"] == 8 and np.isfinite(logs[-1]["loss"])


@pytest.mark.parametrize("flag", ["--mesh=data=1,model=1", "--shard_primitives",
                                  "--distributed", "--port=6009",
                                  "--gradient_tracking", "--debug_mode"])
def test_unported_flags_raise(flag, tmp_path):
    # every flag is ported now (tests/test_torch_debug_images.py,
    # tests/test_torch_viewer.py, tests/test_torch_gradient_tracker.py,
    # tests/test_torch_multihost.py): the flag passes and the missing scene
    # raises. A one-rank mesh runs in this process; --distributed is given a
    # world of this one process, and the group is closed again.
    import torch.distributed as dist

    extra = [flag]
    if flag == "--distributed":
        extra += ["--coordinator_address", f"file://{tmp_path}/store",
                  "--num_processes", "1", "--process_id", "0"]
    with pytest.raises(ValueError, match="could not recognize"):
        train_torch.main(["-s", "/nonexistent", *extra, "--device", "cpu",
                          "--model_path", str(tmp_path / "model")])
    assert not dist.is_initialized()


def test_chip_smoke_cli_phase_on_cpu(tmp_path):
    """``chip_smoke.py`` phase 10 (b) on the CPU at 64×64: the scene writer
    (whose frames JAX's Pillow loader reads as the port's does, and whose
    cameras the loader rebuilds to 1e-6) and the chain's checks."""
    import chip_smoke
    from fourdgs_tpu.data.blender import load_blender_scene as jload_blender

    dev = torch.device("cpu")
    data_dir = str(tmp_path / "data")
    cams = chip_smoke.write_dnerf_scene(data_dir, dev, size=64, n_train=4, n_test=2)
    got = load_scene(tload(), data_dir)
    want = jload_blender(data_dir, target_size=(64, 64))
    for split in ("train", "test"):
        loaded = getattr(got, f"{split}_cameras")
        assert len(loaded) == len(cams[split])
        for lc, jlc, cam in zip(loaded, getattr(want, f"{split}_cameras"), cams[split]):
            np.testing.assert_array_equal(lc.image, jlc.image)
            for f in ("world_view", "full_proj", "camera_center"):
                np.testing.assert_allclose(getattr(lc.camera, f), getattr(cam, f),
                                           rtol=1e-6, atol=1e-6, err_msg=f)
            assert lc.camera.time == pytest.approx(cam.time)
        assert max(lc.image.min() for lc in loaded) < 200   # the balls are in view
    schedule = [o for o in OVERRIDES if not o.startswith("opt.")] + [
        "opt.coarse_iterations=3", "opt.iterations=4", "opt.position_lr_max_steps=4"]
    cli = chip_smoke.run_cli_chain(data_dir, str(tmp_path / "model"), dev, schedule)
    assert cli["steps"] == 7 and cli["test_views"] == 2 and cli["eval_renders"] == 6
    assert cli["render_max_level_diff"] == 0
    assert np.isfinite(cli["psnr"]) and np.isfinite(cli["blank_psnr"])
    assert cli["train_launches"] == cli["render_launches"] == (0, 0)   # plain path
