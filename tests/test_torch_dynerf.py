"""The port's DyNeRF (Neu3D) loader against the JAX package's, on a
``poses_bounds.npy`` scene fabricated as ``tests/test_loaders.py``'s
``TestDynerfScene`` does (frames written by the port's PNG writer, every
filter type in turn): cameras, times, splits, the spiral video cameras,
the normalization, the point cloud and every lazy frame equal JAX's
(exactly: both loaders run the same float64 NumPy, and both decoders are
lossless). ``load_scene`` dispatches ``"dynerf"`` with JAX's default frame
size; a frame of another size is resized with LANCZOS when it is read, as
JAX's is. A scene of ``cam*.mp4`` without extracted frames is extracted as
JAX's loader extracts it (``_extract_video_frames``, cv2 and Pillow): the
same PNG pixels, the same loaded images (H.264 and, as cv2's VideoWriter
writes it, MPEG-4 Part 2); a video the decoder does not read raises, naming
the feature (MJPEG in an .mp4 too); a scene under a dotted directory keeps its
frames inside it (the port's ``os.path.splitext``, where JAX cuts the path
at its first dot)."""

import inspect
import os
import pathlib

import numpy as np
import pytest

from fourdgs_tpu.data import dynerf as jdynerf
from fourdgs_tpu_torch.configs.core import load_config as tload
from fourdgs_tpu_torch.data import dynerf as tdynerf
from fourdgs_tpu_torch.data import scene as tscene
from fourdgs_tpu_torch.data.ply import store_pointcloud
from fourdgs_tpu_torch.utils import png, video
from tests import h264_writer as HW

W, H = 32, 24
CAMERA_FIELDS = ("world_view", "full_proj", "camera_center", "tanfovx",
                 "tanfovy", "width", "height", "time")


def make_dynerf_scene(root, n_cams=3, n_frames=4, size=(W, H), seed=0):
    """``test_loaders.py:110-135``'s scene: identity rotations, random
    translations, (H, W, focal) = (24, 32, 40), near/far (1, 10), random
    RGB frames, a 50-point cloud."""
    rng = np.random.default_rng(seed)
    poses = np.zeros((n_cams, 3, 5))
    for i in range(n_cams):
        poses[i, :, :3] = np.eye(3)
        poses[i, :, 3] = rng.normal(size=3)
        poses[i, :, 4] = [24, 32, 40.0]
    pb = np.concatenate([poses.reshape(n_cams, -1), np.tile([[1.0, 10.0]], (n_cams, 1))],
                        axis=1)
    np.save(root / "poses_bounds.npy", pb)
    for c in range(n_cams):
        d = root / f"cam{c:02d}" / "images"
        d.mkdir(parents=True)
        for f in range(n_frames):
            png.write_png(str(d / f"{f:04d}.png"),
                          rng.integers(0, 255, (size[1], size[0], 3), dtype=np.uint8),
                          filter_type=(c + f) % 5)
    store_pointcloud(str(root / "points3D_downsample2.ply"),
                     rng.normal(size=(50, 3)).astype(np.float32),
                     rng.uniform(0, 255, (50, 3)))


def _same_camera(got, want, what):
    for f in CAMERA_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)), err_msg=f"{what}: {f}")


def _same_scene(got, want):
    assert got.dataset_type == want.dataset_type == "dynerf"
    assert got.maxtime == want.maxtime
    for split in ("train_cameras", "test_cameras"):
        g, w = getattr(got, split), getattr(want, split)
        assert len(g) == len(w) > 0
        for i, (lg, lw) in enumerate(zip(g, w)):
            _same_camera(lg.camera, lw.camera, f"{split}[{i}]")
            assert lg.image.path == lw.image.path
            assert tuple(lg.image.size) == tuple(lw.image.size)
            assert lg.image.shape == lw.image.shape and lg.image.ndim == lw.image.ndim == 3
            np.testing.assert_array_equal(lg.image(), lw.image())
    assert len(got.video_cameras) == len(want.video_cameras) == 300
    for i, (g, w) in enumerate(zip(got.video_cameras, want.video_cameras)):
        _same_camera(g, w, f"video[{i}]")
    for f in ("points", "colors", "normals"):
        np.testing.assert_array_equal(getattr(got.point_cloud, f),
                                      getattr(want.point_cloud, f))
    np.testing.assert_array_equal(got.nerf_normalization["translate"],
                                  want.nerf_normalization["translate"])
    assert got.nerf_normalization["radius"] == want.nerf_normalization["radius"]


def test_loader_matches_jax(tmp_path):
    make_dynerf_scene(tmp_path)
    got = tdynerf.load_dynerf_scene(str(tmp_path), target_wh=(W, H), n_frames=4)
    want = jdynerf.load_dynerf_scene(str(tmp_path), target_wh=(W, H), n_frames=4)
    _same_scene(got, want)
    # camera 0 held out; camera-major order; times fi / n_frames
    assert len(got.train_cameras) == 8 and len(got.test_cameras) == 4
    assert [lc.camera.time for lc in got.test_cameras] == [0.0, 0.25, 0.5, 0.75]
    assert got.train_cameras[0].image.path.endswith("cam01/images/0000.png")
    assert got.train_cameras[4].image.path.endswith("cam02/images/0000.png")


def test_loader_default_frames_and_eval_index(tmp_path):
    """300-frame times (the loader's default ``n_frames``) and another
    held-out camera."""
    make_dynerf_scene(tmp_path, n_frames=3)
    got = tdynerf.load_dynerf_scene(str(tmp_path), eval_index=2, target_wh=(W, H))
    want = jdynerf.load_dynerf_scene(str(tmp_path), eval_index=2, target_wh=(W, H))
    _same_scene(got, want)
    assert got.test_cameras[1].camera.time == 1 / 300 and got.maxtime == 300.0


def test_load_scene_dispatches_dynerf(tmp_path, monkeypatch):
    make_dynerf_scene(tmp_path)
    assert tscene.sniff_dataset_type(str(tmp_path)) == "dynerf"
    # JAX's default frame size (scene.py:58-60 calls the loader without one)
    default = inspect.signature(jdynerf.load_dynerf_scene).parameters["target_wh"].default
    assert tscene.DYNERF_SIZE == tuple(default) == (1352, 1014)
    data = tscene.load_scene(tload(), str(tmp_path))
    assert data.train_cameras[0].image.size == (1352, 1014)
    ref = data.train_cameras[0].image     # a 32×24 frame, 1352×1014 wanted
    np.testing.assert_array_equal(ref(), jdynerf.ImageRef(ref.path, ref.size)())
    monkeypatch.setattr(tscene, "DYNERF_SIZE", (W, H))
    got = tscene.load_scene(tload(), str(tmp_path))
    want = jdynerf.load_dynerf_scene(str(tmp_path), target_wh=(W, H))
    _same_scene(got, want)


def test_frame_of_another_size_raises(tmp_path):
    make_dynerf_scene(tmp_path)
    path = tmp_path / "cam01" / "images" / "0002.png"
    png.write_png(str(path), np.zeros((H, W + 1, 3), np.uint8))
    data = tdynerf.load_dynerf_scene(str(tmp_path), target_wh=(W, H), n_frames=4)
    ref = next(lc.image for lc in data.train_cameras if lc.image.path == str(path))
    # resized with LANCZOS, as JAX's ref resizes it with Pillow
    np.testing.assert_array_equal(ref(), jdynerf.ImageRef(ref.path, ref.size)())
    assert ref().shape == data.train_cameras[0].image().shape == (H, W, 3)


def test_frame_modes_read_as_rgb(tmp_path):
    """RGBA drops its alpha and gray is replicated, as Pillow's
    ``convert("RGB")`` does in JAX's ref."""
    make_dynerf_scene(tmp_path)
    rng = np.random.default_rng(3)
    d = tmp_path / "cam00" / "images"
    rgba = rng.integers(0, 255, (H, W, 4), dtype=np.uint8)
    gray = rng.integers(0, 255, (H, W), dtype=np.uint8)
    png.write_png(str(d / "0000.png"), rgba)
    png.write_png(str(d / "0001.png"), gray)
    got = tdynerf.load_dynerf_scene(str(tmp_path), target_wh=(W, H), n_frames=4)
    want = jdynerf.load_dynerf_scene(str(tmp_path), target_wh=(W, H), n_frames=4)
    np.testing.assert_array_equal(got.test_cameras[0].image(), rgba[:, :, :3])
    np.testing.assert_array_equal(got.test_cameras[1].image(), np.repeat(gray[:, :, None], 3, 2))
    for i in (0, 1):
        np.testing.assert_array_equal(got.test_cameras[i].image(), want.test_cameras[i].image())


VIDEO_SIZE = (58, 42)       # no multiple of 16 either way; resized to (W, H)


def write_video(path, seed, frames=3, size=VIDEO_SIZE, b_frames=0, cavlc=False, codec="h264"):
    if codec == "mp4v":
        # MPEG-4 Part 2 as cv2's VideoWriter writes an .mp4
        import cv2

        vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 25, size)
        rng = np.random.default_rng(seed)
        base = rng.integers(0, 256, (size[1] + 2 * frames, size[0] + 2 * frames, 3), np.uint8)
        for i in range(frames):
            vw.write(np.ascontiguousarray(base[i:i + size[1], 2 * i:2 * i + size[0]]))
        vw.release()
        return
    cfg = HW.Config(width=size[0], height=size[1], frames=frames, seed=seed, b_frames=b_frames,
                    cavlc=cavlc)
    sps, pps, aus = HW.write(cfg)
    path.write_bytes(HW.mp4(sps, pps, aus, *size))


def make_video_scene(root, n_cams=2, frames=3):
    """:func:`make_dynerf_scene`'s poses and cloud with ``cam*.mp4`` and no
    extracted frames."""
    make_dynerf_scene(root, n_cams=n_cams, n_frames=1)
    for c in range(n_cams):
        cam = root / f"cam{c:02d}"
        for f in (cam / "images").iterdir():
            f.unlink()
        (cam / "images").rmdir()
        cam.rmdir()
        write_video(root / f"cam{c:02d}.mp4", seed=c, frames=frames)


@pytest.mark.parametrize("n_frames,b_frames,frames,cavlc,codec",
                         [(2, 0, 3, False, "h264"), (10, 0, 3, False, "h264"),
                          (10, 3, 7, False, "h264"), (10, 3, 7, True, "h264"),
                          (20, 0, 14, False, "mp4v")],
                         ids=["2", "10", "b-10", "cavlc", "mp4v"])
def test_extract_matches_jax(tmp_path, n_frames, b_frames, frames, cavlc, codec):
    """The port's ``extract_video_frames`` and JAX's
    ``_extract_video_frames`` on one mp4 (H.264: I and P slices, or runs of
    up to 3 B pictures coded after the next anchor, coded with CABAC or
    CAVLC; or MPEG-4 Part 2 as cv2's VideoWriter writes it, I- and P-VOPs
    with a second I-VOP): the same files, equal pixels; ``n_frames`` stops
    early or the video's end does."""
    path = tmp_path / "cam00.mp4"
    write_video(path, seed=5, frames=frames, b_frames=b_frames, cavlc=cavlc, codec=codec)
    jdynerf._extract_video_frames(str(path), str(tmp_path / "jax"), (W, H), n_frames)
    assert video.extract_video_frames(str(path), str(tmp_path / "port"), (W, H),
                                      n_frames) == min(n_frames, frames)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert names == ["%04d.png" % i for i in range(min(n_frames, frames))]
    for n in names:
        np.testing.assert_array_equal(png.read_png(str(tmp_path / "port" / n)),
                                      png.read_png(str(tmp_path / "jax" / n)), err_msg=n)


def test_videos_only_scene_matches_jax(tmp_path, monkeypatch):
    """A scene of videos only, loaded by JAX's loader (which extracts with
    cv2 and Pillow), then, its frames removed, by the port's (which
    extracts with its own decoder): the cameras, splits and frame paths
    agree, and every image the port loads equals JAX's. The scene is named
    by a relative path without a dot, which JAX's ``v.split(".")[0]``
    needs."""
    monkeypatch.chdir(tmp_path)
    root = pathlib.Path("scene")
    root.mkdir()
    make_video_scene(root)
    want = jdynerf.load_dynerf_scene(str(root), target_wh=(W, H), n_frames=4)
    want_images = [lc.image() for lc in want.train_cameras + want.test_cameras]
    for c in range(2):
        for f in (root / f"cam{c:02d}" / "images").iterdir():
            f.unlink()
        (root / f"cam{c:02d}" / "images").rmdir()
    got = tdynerf.load_dynerf_scene(str(root), target_wh=(W, H), n_frames=4)
    _same_scene(got, want)
    assert len(got.train_cameras) == 3 and len(got.test_cameras) == 3
    for g, w in zip(got.train_cameras + got.test_cameras, want_images):
        np.testing.assert_array_equal(g.image(), w, err_msg=g.image.path)


def test_video_the_decoder_refuses_names_its_feature(tmp_path):
    """A camera whose video codes 4:2:2 chroma (a feature the decoder
    refuses) raises while the loader extracts it, naming 4:2:0 (no partial
    frame is written)."""
    make_video_scene(tmp_path)
    data, _ = HW.header_only("chroma_422")
    (tmp_path / "cam01.mp4").write_bytes(data)
    with pytest.raises(NotImplementedError, match="4:2:0"):
        tdynerf.load_dynerf_scene(str(tmp_path), target_wh=(W, H))


def test_video_the_decoder_refuses_names_its_codec(tmp_path):
    """A camera that cv2's VideoWriter wrote with its MJPG fourcc (MJPEG in
    an .mp4: an ``mp4v`` sample entry of objectTypeIndication 0x6C, a codec
    the decoders refuse) raises while the loader extracts it, naming MJPEG."""
    import cv2

    make_video_scene(tmp_path)
    path = tmp_path / "cam01.mp4"
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 25, VIDEO_SIZE)
    for v in (40, 160):
        vw.write(np.full((VIDEO_SIZE[1], VIDEO_SIZE[0], 3), v, np.uint8))
    vw.release()
    with pytest.raises(NotImplementedError, match="MJPEG"):
        tdynerf.load_dynerf_scene(str(tmp_path), target_wh=(W, H))


def test_dotted_scene_directory_keeps_its_frames(tmp_path):
    """Under ``n3v.v1/coffee`` the port extracts into the scene's
    ``cam*/images``; JAX's ``v.split(".")[0]`` would name ``…/n3v``, outside
    it (ROADMAP.md Queue 3 keeps that divergence)."""
    root = tmp_path / "n3v.v1" / "coffee"
    root.mkdir(parents=True)
    make_video_scene(root)
    got = tdynerf.load_dynerf_scene(str(root), target_wh=(W, H))
    assert sorted(os.listdir(root / "cam00" / "images")) == ["0000.png", "0001.png", "0002.png"]
    assert not (tmp_path / "n3v").exists()
    assert str(root / "cam00.mp4").split(".")[0] == str(tmp_path / "n3v")
    assert all(lc.image.path.startswith(str(root)) for lc in got.test_cameras)
