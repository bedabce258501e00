"""The port's HyperNeRF (Nerfies) loader against the JAX package's.

Scenes written as ``tests/test_loaders.py::TestHypernerfScene`` writes its
fixture (``scene.json``, ``metadata.json``, ``dataset.json``,
``camera/<id>.json``, Pillow frames under ``rgb/2x``), from a seed: random
rotations, positions, focal lengths and odd full-resolution sizes (the
loader halves them with ``int``), plus covisible masks under
``covisible/2x/val`` and each of the three init-cloud sources.

- Both split layouts: ``val_ids`` given (vrig) and none (the 4:1 split).
- ``load_hypernerf_scene`` against JAX's: each camera's matrices, FoVs,
  size and time, the image and mask paths, the video cameras (the smoothed
  path, capped at 500), the point cloud, ``nerf_normalization`` and
  ``maxtime``: paths and counts exact, floats to 1e-12 (both are float64
  numpy, the matrices float32 from the same arithmetic).
- The frames against Pillow's decode and JAX's ``ImageRef``, exact (PNG); a
  frame of another size is resized (LANCZOS) as JAX resizes it, and so is a
  mask (BILINEAR), bit for bit.
- ``load_scene`` dispatches ``"nerfies"``.
"""

import json
import os

import numpy as np
import pytest
from PIL import Image

from fourdgs_tpu.data import hypernerf as JH
from fourdgs_tpu.data.ply import store_pointcloud
from fourdgs_tpu.utils.pose_utils import quaternion_to_rotation_matrix
from fourdgs_tpu_torch.configs.core import load_config as tload
from fourdgs_tpu_torch.data import hypernerf as TH
from fourdgs_tpu_torch.data import scene as tscene

TOL = dict(rtol=1e-12, atol=1e-12)
CAMERA_FIELDS = ("world_view", "full_proj", "camera_center", "tanfovx", "tanfovy",
                 "width", "height", "time")


def write_hypernerf(root, n=12, vrig=True, clouds=("points.npy",), frames=True,
                    full_size=(65, 49), seed=0, frame_size=None):
    """A HyperNeRF scene under ``root`` of ``n`` ids; ``vrig``: even ids
    train, odd ids validate (else no ``val_ids``: the 4:1 split); covisible
    masks (random 0/255, some grey levels) for every id; ``clouds``: the
    init-cloud files to write. Frames at half ``full_size`` unless
    ``frame_size``. Returns the ids."""
    rng = np.random.default_rng(seed)
    ids = [f"{i:04d}" for i in range(n)]
    (root / "camera").mkdir(parents=True)
    with open(root / "scene.json", "w") as f:
        json.dump({"near": 0.1, "far": 10.0, "scale": 0.7, "center": [0.1, -0.2, 0.3]}, f)
    with open(root / "metadata.json", "w") as f:
        json.dump({k: {"camera_id": i % 2, "warp_id": int(rng.integers(0, 50))}
                   for i, k in enumerate(ids)}, f)
    ds = {"ids": ids, "val_ids": []}
    if vrig:
        ds.update(train_ids=ids[0::2], val_ids=ids[1::2])
    with open(root / "dataset.json", "w") as f:
        json.dump(ds, f)
    W0, H0 = full_size
    w, h = frame_size or (int(W0 * 0.5), int(H0 * 0.5))
    if frames:
        (root / "rgb" / "2x").mkdir(parents=True)
        (root / "covisible" / "2x" / "val").mkdir(parents=True)
    for k in ids:
        q = rng.normal(size=4)
        with open(root / "camera" / f"{k}.json", "w") as f:
            json.dump({
                "orientation": quaternion_to_rotation_matrix(q).tolist(),
                "position": rng.normal(0, 2, 3).tolist(),
                "focal_length": float(rng.uniform(40, 90)),
                "principal_point": [W0 / 2, H0 / 2], "image_size": [W0, H0],
                "pixel_aspect_ratio": 1.0, "skew": 0.0,
                "radial_distortion": [0.0, 0.0, 0.0], "tangential_distortion": [0.0, 0.0],
            }, f)
        if frames:
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
                root / "rgb" / "2x" / f"{k}.png")
            mask = np.where(rng.uniform(size=(h, w)) < 0.3, 0, 255).astype(np.uint8)
            mask[0, :4] = [1, 7, 128, 0]
            Image.fromarray(mask).save(root / "covisible" / "2x" / "val" / f"{k}.png")
    pts = rng.normal(size=(40, 3))
    for name in clouds:
        if name == "points.npy":
            np.save(root / name, pts)
        else:
            store_pointcloud(str(root / name), pts.astype(np.float32) + len(name),
                             rng.uniform(0, 255, (40, 3)))
    return ids


def assert_same_camera(got, want):
    for f in CAMERA_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if isinstance(w, (int, float)):
            assert g == pytest.approx(w, rel=1e-12, abs=1e-12), f
        else:
            np.testing.assert_allclose(g, w, err_msg=f, **TOL)


def assert_same_scene(got, want):
    assert got.dataset_type == want.dataset_type == "nerfies"
    assert got.maxtime == want.maxtime
    for split in ("train_cameras", "test_cameras"):
        g_list, w_list = getattr(got, split), getattr(want, split)
        assert len(g_list) == len(w_list) > 0
        for g, w in zip(g_list, w_list):
            assert_same_camera(g.camera, w.camera)
            assert g.image.path == w.image.path and tuple(g.image.size) == tuple(w.image.size)
            assert g.mask_path == w.mask_path
    assert len(got.video_cameras) == len(want.video_cameras)
    for g, w in zip(got.video_cameras, want.video_cameras):
        assert_same_camera(g, w)
    for f in ("points", "colors", "normals"):
        np.testing.assert_array_equal(getattr(got.point_cloud, f), getattr(want.point_cloud, f))
    assert got.nerf_normalization["radius"] == pytest.approx(
        want.nerf_normalization["radius"], rel=1e-12)
    np.testing.assert_allclose(got.nerf_normalization["translate"],
                               want.nerf_normalization["translate"], **TOL)


@pytest.mark.parametrize("vrig", [True, False], ids=["vrig", "interleaved"])
def test_loader_matches_jax(tmp_path, vrig):
    ids = write_hypernerf(tmp_path, n=13, vrig=vrig)
    got = TH.load_hypernerf_scene(str(tmp_path))
    want = JH.load_hypernerf_scene(str(tmp_path))
    assert_same_scene(got, want)
    if vrig:
        assert [os.path.basename(lc.image.path)[:-4] for lc in got.test_cameras] == ids[1::2]
    else:   # train = ids[0::4], test = train + 2 without the last
        assert len(got.train_cameras) == 4 and len(got.test_cameras) == 3
    assert all(lc.mask_path is None for lc in got.train_cameras)
    assert all(os.path.exists(lc.mask_path) for lc in got.test_cameras)
    for g, w in zip(got.train_cameras + got.test_cameras,
                    want.train_cameras + want.test_cameras):
        frame = g.image()
        np.testing.assert_array_equal(frame, w.image())
        np.testing.assert_array_equal(frame, np.asarray(Image.open(g.image.path).convert("RGB")))
        assert frame.shape == (24, 32, 3)
    for lc in got.test_cameras:     # the masks as the eval and render_torch read them
        np.testing.assert_array_equal(
            TH.read_mask(lc.mask_path, 32, 24),
            np.asarray(Image.open(lc.mask_path).convert("L")))


@pytest.mark.parametrize("clouds", [
    ("points.npy",), ("points3D_downsample.ply", "points.npy"),
    ("points3D_downsample2.ply", "points3D_downsample.ply", "points.npy")],
    ids=["npy", "ply", "ply2"])
def test_init_cloud_sources(tmp_path, clouds):
    write_hypernerf(tmp_path, n=9, clouds=clouds, frames=False)
    got = TH.load_hypernerf_scene(str(tmp_path))
    assert_same_scene(got, JH.load_hypernerf_scene(str(tmp_path)))
    if clouds[0] == "points.npy":   # centred and scaled by scene.json
        raw = np.load(tmp_path / "points.npy")
        np.testing.assert_allclose(got.point_cloud.points,
                                   ((raw.astype(np.float32) - [0.1, -0.2, 0.3]) * 0.7),
                                   rtol=1e-6)
        assert (got.point_cloud.colors == 0.5).all()


def test_no_cloud_raises(tmp_path):
    write_hypernerf(tmp_path, n=5, clouds=(), frames=False)
    with pytest.raises(FileNotFoundError, match="no init point cloud"):
        TH.load_hypernerf_scene(str(tmp_path))


def test_video_path_is_capped(tmp_path):
    """60 key poses make 650 smoothed ones; the path keeps 500."""
    write_hypernerf(tmp_path, n=240, vrig=False, frames=False)
    got = TH.load_hypernerf_scene(str(tmp_path))
    want = JH.load_hypernerf_scene(str(tmp_path))
    assert len(got.train_cameras) == 60 and len(got.video_cameras) == 500
    assert_same_scene(got, want)


def test_one_train_camera_uses_the_test_views_as_video(tmp_path):
    write_hypernerf(tmp_path, n=2, vrig=True, frames=False)
    got = TH.load_hypernerf_scene(str(tmp_path))
    assert len(got.train_cameras) == 1 and len(got.video_cameras) == 1
    assert_same_scene(got, JH.load_hypernerf_scene(str(tmp_path)))


def test_frames_and_masks_of_another_size_raise(tmp_path):
    write_hypernerf(tmp_path, n=5, frame_size=(30, 20))
    got = TH.load_hypernerf_scene(str(tmp_path))
    want = JH.load_hypernerf_scene(str(tmp_path))
    # both resize: the frame with LANCZOS, the mask with BILINEAR (train.py:193-194)
    assert want.train_cameras[0].image().shape == (24, 32, 3)
    np.testing.assert_array_equal(got.train_cameras[0].image(), want.train_cameras[0].image())
    mask_path = got.test_cameras[0].mask_path
    np.testing.assert_array_equal(
        TH.read_mask(mask_path, 32, 24),
        np.asarray(Image.open(mask_path).convert("L").resize((32, 24), Image.BILINEAR)))


def test_load_scene_dispatches_nerfies(tmp_path):
    write_hypernerf(tmp_path, n=9)
    assert tscene.sniff_dataset_type(str(tmp_path)) == "nerfies"
    cfg = tload(os.path.join(os.path.dirname(__file__), "..", "fourdgs_tpu", "configs",
                             "presets", "hypernerf", "default.py"))
    assert_same_scene(tscene.load_scene(cfg, str(tmp_path)),
                      JH.load_hypernerf_scene(str(tmp_path)))
