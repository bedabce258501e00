"""``chip_smoke.py`` phase 11 (c) on the CPU at a tiny size: the DyNeRF scene
writer (``write_dynerf_scene``) and ``train_torch.py`` → ``render_torch.py``
→ ``metrics_torch.py`` on its lazy frames with the dynerf preset (its
widths and batch cut, as ``tests/test_torch_cli.py`` cuts the D-NeRF
preset's).

- The writer's ``poses_bounds.npy`` inverts the LLFF convention: the
  port's and JAX's loaders rebuild the cameras it rendered (within 1e-6,
  float32 matrices through float64 poses), and both read its frames alike.
- The training decodes every frame of every batch natively (the
  prefetcher's counts), the FineSampler engages on the camera-major layout
  (no warning), the in-training eval and ``render_torch.py`` call the refs
  (the GT PNGs are the source frames), and the chain's checks pass."""

import numpy as np
import pytest
import torch

import bench_quality_dynerf_torch as BD
import chip_smoke
from fourdgs_tpu.data.dynerf import load_dynerf_scene as jload_dynerf
from fourdgs_tpu_torch.configs.core import load_config as tload
from fourdgs_tpu_torch.data import scene as tscene
from fourdgs_tpu_torch.utils import png
from tests.test_torch_cli import one_torch_thread  # noqa: F401  (autouse)

W, H, FRAMES = 72, 56, 2
OVERRIDES = [
    "opt.coarse_iterations=1", "opt.iterations=2", "opt.position_lr_max_steps=2",
    "opt.batch_size=2", 'opt.custom_sampler="fine"', "opt.densify_from_iter=1000",
    "opt.pruning_from_iter=1000", "tpu.capacity=16384", "tpu.instance_budget=65536",
    "tpu.tile_budget=256", "tpu.blend_chunk=64", "hidden.net_width=16",
    "hidden.multires=[1]",
    'hidden.kplanes_config={"grid_dimensions": 2, "input_coordinate_dim": 4, '
    '"output_coordinate_dim": 8, "resolution": [8, 8, 8, 4]}',
]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("dynerf_scene")
    cams = chip_smoke.write_dynerf_scene(str(root), torch.device("cpu"), n_frames=FRAMES,
                                         size=(W, H))
    return str(root), cams


def test_written_scene_loads_back(scene, monkeypatch):
    root, cams = scene
    monkeypatch.setattr(tscene, "DYNERF_SIZE", (W, H))
    got = tscene.load_scene(tload(), root)
    want = jload_dynerf(root, target_wh=(W, H))
    assert len(cams) == 4 and all(len(c) == FRAMES for c in cams.values())
    assert len(got.train_cameras) == 3 * FRAMES and len(got.test_cameras) == FRAMES
    written = [c for ci in (1, 2, 3) for c in cams[ci]]
    for split, mine in (("train_cameras", written), ("test_cameras", cams[0])):
        for lc, jlc, cam in zip(getattr(got, split), getattr(want, split), mine):
            for f in ("world_view", "full_proj", "camera_center"):
                np.testing.assert_array_equal(getattr(lc.camera, f), getattr(jlc.camera, f))
                np.testing.assert_allclose(getattr(lc.camera, f), getattr(cam, f),
                                           rtol=1e-6, atol=1e-6, err_msg=f)
            assert lc.camera.time == jlc.camera.time == cam.time
            assert lc.camera.tanfovy == pytest.approx(cam.tanfovy, rel=1e-12)
            np.testing.assert_array_equal(lc.image(), jlc.image())
    frame = got.test_cameras[0].image()
    assert frame.shape == (H, W, 3) and frame.min() < 200 < frame.max()   # the balls
    np.testing.assert_array_equal(got.point_cloud.points,
                                  BD.init_cloud(BD.make_gt_scene()[0])[0])


def test_cli_chain_on_lazy_frames(scene, tmp_path, monkeypatch, capsys):
    root, _ = scene
    monkeypatch.setattr(tscene, "DYNERF_SIZE", (W, H))
    cli = chip_smoke.run_cli_chain(root, str(tmp_path / "model"), torch.device("cpu"),
                                   OVERRIDES, BD.PRESET)
    out = capsys.readouterr().out
    assert "[sampler] WARNING" not in out
    renders = cli["steps"] * cli["batch_size"]
    assert cli["steps"] == 3 and cli["batch_size"] == 2
    assert cli["prefetch"] == {"submitted": renders, "native": renders, "to_ref": 0}
    assert "[prefetch] fine: 4 frames submitted, 4 decoded natively" in out
    # the eval: the test views and five of the train views
    assert cli["test_views"] == FRAMES and cli["eval_renders"] == FRAMES + 5
    assert cli["render_max_level_diff"] == 0
    assert np.isfinite(cli["psnr"]) and cli["psnr"] > cli["blank_psnr"]
    assert cli["train_launches"] == cli["render_launches"] == (0, 0)   # plain path
    for stage in ("coarse", "fine"):
        assert 0 <= cli["data_loading"][stage]["share"] < 1
    # render_torch.py wrote the refs' frames as the GT
    for i in range(FRAMES):
        np.testing.assert_array_equal(
            png.read_png(str(tmp_path / "model" / "test" / "ours_2" / "gt" / f"{i:05d}.png")),
            png.read_png(f"{root}/cam00/images/{i:04d}.png"))
