"""The port's COLMAP model I/O and its COLMAP, MultipleView and Panoptic
loaders against the JAX package's, on JPEG frames.

- ``colmap_io``: binary and text round trips of a random model (every
  camera model, tracks, empty observations), models written by JAX's writers
  read by the port's readers and the reverse, equal leaf for leaf; the
  quaternion helpers.
- The loaders on fixtures with JPEG frames written by Pillow: COLMAP and
  Panoptic as ``tests/test_loaders.py`` writes them (``.jpg`` in place of
  ``.png``), MultipleView as ``cam01…cam03/frame_%05d.jpg``, ``sparse_/0``,
  ``poses_bounds_multipleview.npy`` and ``points3D_multipleview.ply``; and
  ``chip_smoke.py`` phase 12 (b)'s scenes of the committed frames. Cameras
  exact or 1e-12, frames against JAX's ``ImageRef`` (Pillow) to the JPEG
  tolerance of ``tests/test_torch_jpeg.py``.
- ``sniff_dataset_type`` and ``load_scene`` dispatch for all six types.
- Phase 12 (b) on the CPU at a narrow width: ``check_jpeg_path``.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke as CS
from fourdgs_tpu.configs.core import load_config as jload
from fourdgs_tpu.data import colmap as JC
from fourdgs_tpu.data import colmap_io as JIO
from fourdgs_tpu.data import multipleview as JMV
from fourdgs_tpu.data import panoptic as JP
from fourdgs_tpu.data import scene as jscene
from fourdgs_tpu.data.ply import store_pointcloud
from fourdgs_tpu_torch.configs.core import load_config as tload
from fourdgs_tpu_torch.data import colmap as TC
from fourdgs_tpu_torch.data import colmap_io as TIO
from fourdgs_tpu_torch.data import scene as tscene
from tests.test_data import make_dnerf_dataset
from tests.test_torch_cli import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_dynerf_cli import OVERRIDES as NARROW
from tests.test_torch_hypernerf import assert_same_camera, write_hypernerf

W, H = 40, 30


def random_model(rng, io=JIO, empty_image=True):
    """A COLMAP model with a camera of every model id, images with (and,
    with ``empty_image``, one without) observations, and points with
    tracks."""
    cams = {}
    for mid, (name, n_params) in io.CAMERA_MODELS.items():
        cams[mid + 1] = io.ColmapCamera(mid + 1, name, int(rng.integers(10, 2000)),
                                        int(rng.integers(10, 2000)), rng.normal(size=n_params))
    imgs = {}
    for iid in (1, 2, 5):
        n = 0 if iid == 2 and empty_image else 4
        q = rng.normal(size=4)
        imgs[iid] = io.ColmapImage(iid, q / np.linalg.norm(q), rng.normal(size=3),
                                   int(rng.integers(1, 12)), f"img_{iid:03d}.jpg",
                                   rng.normal(size=(n, 2)), rng.integers(-1, 50, n))
    pts = {pid: io.ColmapPoint3D(pid, rng.normal(size=3),
                                 rng.integers(0, 256, 3).astype(np.uint8),
                                 float(rng.uniform()), rng.integers(1, 6, 3).astype(np.int32),
                                 rng.integers(0, 4, 3).astype(np.int32))
           for pid in (3, 7, 8)}
    return cams, imgs, pts


def assert_same_model(got, want):
    for g_dict, w_dict in zip(got, want):
        assert sorted(g_dict) == sorted(w_dict)
        for k in w_dict:
            g, w = g_dict[k], w_dict[k]
            assert type(g).__name__ == type(w).__name__ and g._fields == w._fields
            for f in w._fields:
                gv, wv = getattr(g, f), getattr(w, f)
                if isinstance(wv, np.ndarray):
                    np.testing.assert_array_equal(np.asarray(gv).reshape(wv.shape), wv,
                                                  err_msg=f)
                else:
                    assert gv == wv, f


@pytest.mark.parametrize("ext", [".bin", ".txt"])
@pytest.mark.parametrize("writer,reader", [(JIO, TIO), (TIO, JIO), (TIO, TIO)],
                         ids=["jax_to_port", "port_to_jax", "port_round_trip"])
def test_model_io(tmp_path, ext, writer, reader):
    # JAX's text reader drops an image's empty POINTS2D line
    # (test_text_reader_drops_an_empty_observation_line): text models here
    # give every image an observation
    model = random_model(np.random.default_rng(0), writer, empty_image=ext == ".bin")
    writer.write_model(*model, str(tmp_path), ext=ext)
    got = reader.read_model_full(str(tmp_path), ext)
    want = JIO.read_model_full(str(tmp_path), ext)
    assert_same_model(got, want)
    assert_same_model(got, model)
    g_cams, g_imgs, g_pts = reader.read_model(str(tmp_path))
    w_cams, w_imgs, w_pts = JIO.read_model(str(tmp_path))
    assert_same_model((g_cams, g_imgs), (w_cams, w_imgs))
    for g, w in zip(g_pts, w_pts):
        np.testing.assert_array_equal(g, w)


def test_text_reader_drops_an_empty_observation_line(tmp_path):
    """JAX's ``read_images_text`` skips blank lines, so the empty POINTS2D
    line of an image without observations shifts the next image's header
    into it and the read fails. The port reads header and observation lines
    in pairs (a fault of the reference it no longer copies): the image reads
    with zero observations, the others as written, also when the image
    without observations comes last. Where no line is empty, both readers
    agree."""
    for empty_id in (2, 5):
        model = random_model(np.random.default_rng(0))
        cams, imgs, pts = model
        imgs = {iid: im._replace(xys=im.xys[:0], point3d_ids=im.point3d_ids[:0])
                if iid == empty_id else im._replace(xys=im.xys[:4], point3d_ids=im.point3d_ids[:4])
                for iid, im in imgs.items()}
        out = tmp_path / str(empty_id)
        JIO.write_model(cams, imgs, pts, str(out), ext=".txt")
        path = str(out / "images.txt")
        with pytest.raises(ValueError, match="could not convert string to float"):
            JIO.read_images_text(path)
        got = TIO.read_images_text(path)
        assert got[empty_id].xys.shape == (0, 2) and got[empty_id].point3d_ids.shape == (0,)
        assert_same_model((got,), (imgs,))
    full = random_model(np.random.default_rng(1), empty_image=False)
    JIO.write_model(*full, str(tmp_path / "full"), ext=".txt")
    path = str(tmp_path / "full" / "images.txt")
    assert_same_model((TIO.read_images_text(path),), (JIO.read_images_text(path),))


def test_quaternions():
    rng = np.random.default_rng(1)
    for _ in range(20):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        R = TIO.qvec2rotmat(q)
        np.testing.assert_array_equal(R, JIO.qvec2rotmat(q))
        np.testing.assert_allclose(TIO.rotmat2qvec(R), JIO.rotmat2qvec(R), rtol=1e-12,
                                   atol=1e-12)
    with pytest.raises(ValueError):
        TIO.write_model({}, {}, {}, "/nonexistent/x", ext=".ply")


def jpeg_frame(path, rng, size=(W, H)):
    Image.fromarray(rng.integers(0, 256, (size[1], size[0], 3), dtype=np.uint8)).save(
        path, quality=90)


def write_colmap(root, rng, model="PINHOLE", n=9, text=False):
    """``tests/test_loaders.py::write_colmap_binary`` with JPEG frames: one
    camera of ``model``, ``n`` images, five points."""
    params = {"PINHOLE": [30.0, 32.0, W / 2, H / 2], "SIMPLE_PINHOLE": [30.0, W / 2, H / 2],
              "SIMPLE_RADIAL": [30.0, W / 2, H / 2, 0.01],
              "OPENCV": [30.0, 31.0, W / 2, H / 2, 0.0, 0.0, 0.0, 0.0],
              "RADIAL": [30.0, W / 2, H / 2, 0.0, 0.0]}[model]
    cams = {1: JIO.ColmapCamera(1, model, W, H, np.array(params))}
    imgs = {}
    for i in range(n):
        q = rng.normal(size=4)
        imgs[i + 1] = JIO.ColmapImage(i + 1, q / np.linalg.norm(q), rng.normal(size=3), 1,
                                      f"frame{(i * 5) % n:03d}.jpg",
                                      rng.normal(size=(2, 2)), np.array([0, 1]))
    pts = {i: JIO.ColmapPoint3D(i, rng.normal(size=3), np.array([100, 150, 200], np.uint8),
                                0.5, np.array([1], np.int32), np.array([0], np.int32))
           for i in range(5)}
    JIO.write_model(cams, imgs, pts, str(root / "sparse" / "0"), ".txt" if text else ".bin")
    (root / "images").mkdir()
    for i in range(n):
        jpeg_frame(root / "images" / f"frame{i:03d}.jpg", rng)


def write_panoptic(root, rng, n_t=3, n_c=2):
    """``tests/test_loaders.py::TestPanopticScene``'s fixture with JPEG frames."""
    meta = {"w": W, "h": H, "k": [], "w2c": [], "fn": [], "cam_id": []}
    for t in range(n_t):
        ks, w2cs, fns = [], [], []
        for c in range(n_c):
            w2c = np.eye(4)
            w2c[:3, 3] = rng.normal(size=3)
            fn = f"{c}/{t:06d}.jpg"
            (root / "ims" / str(c)).mkdir(parents=True, exist_ok=True)
            jpeg_frame(root / "ims" / fn, rng)
            ks.append([[40.0, 0, W / 2 + 1.5], [0, 41.0, H / 2 - 2.0], [0, 0, 1]])
            w2cs.append(w2c.tolist())
            fns.append(fn)
        meta["k"].append(ks)
        meta["w2c"].append(w2cs)
        meta["fn"].append(fns)
        meta["cam_id"].append(list(range(n_c)))
    for name in ("train_meta.json", "test_meta.json"):
        with open(root / name, "w") as f:
            json.dump(meta, f)
    np.savez(root / "init_pt_cld.npz", data=rng.normal(size=(30, 7)).astype(np.float32))


def write_multipleview(root, rng, n_cams=3, n_frames=5, poses=True):
    cams = {1: JIO.ColmapCamera(1, "SIMPLE_PINHOLE", W, H, np.array([35.0, W / 2, H / 2]))}
    imgs, rows = {}, []
    for c in range(n_cams):
        q = rng.normal(size=4)
        imgs[c + 1] = JIO.ColmapImage(c + 1, q / np.linalg.norm(q), rng.normal(size=3), 1,
                                      f"image{c + 1:02d}.jpg", np.zeros((0, 2)),
                                      np.zeros(0, np.int64))
        (root / f"cam{c + 1:02d}").mkdir(parents=True)
        for f in range(n_frames):
            jpeg_frame(root / f"cam{c + 1:02d}" / f"frame_{f + 1:05d}.jpg", rng)
        pose = np.concatenate([np.linalg.qr(rng.normal(size=(3, 3)))[0],
                               rng.normal(size=(3, 1)), [[H], [W], [35.0]]], axis=1)
        rows.append(np.concatenate([pose.reshape(-1), [0.5, 8.0]]))
    JIO.write_model(cams, imgs, {}, str(root / "sparse_" / "0"))
    if poses:
        np.save(root / "poses_bounds_multipleview.npy", np.stack(rows))
    store_pointcloud(str(root / "points3D_multipleview.ply"),
                     rng.normal(size=(50, 3)).astype(np.float32), rng.uniform(0, 255, (50, 3)))


def assert_same_frames(got_lcs, want_lcs):
    assert len(got_lcs) == len(want_lcs) > 0
    for g, w in zip(got_lcs, want_lcs):
        assert_same_camera(g.camera, w.camera)
        assert g.image.path == w.image.path and tuple(g.image.size) == tuple(w.image.size)
        gi, wi = g.image(), w.image()
        assert gi.shape == wi.shape
        d = np.abs(gi.astype(int) - wi.astype(int))
        assert d.max() <= CS.JPEG_MAX_LEVELS and d.mean() <= CS.JPEG_MEAN_LEVELS


def assert_same_scene(got, want, kind):
    assert got.dataset_type == want.dataset_type == kind
    assert got.maxtime == want.maxtime
    assert_same_frames(got.train_cameras, want.train_cameras)
    if want.test_cameras:
        assert_same_frames(got.test_cameras, want.test_cameras)
    assert len(got.video_cameras) == len(want.video_cameras)
    for g, w in zip(got.video_cameras, want.video_cameras):
        assert_same_camera(g, w)
    for f in ("points", "colors", "normals"):
        np.testing.assert_array_equal(getattr(got.point_cloud, f), getattr(want.point_cloud, f))
    assert got.nerf_normalization["radius"] == pytest.approx(
        want.nerf_normalization["radius"], rel=1e-12)
    np.testing.assert_allclose(got.nerf_normalization["translate"],
                               want.nerf_normalization["translate"], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("model,text,llffhold", [
    ("PINHOLE", False, 8), ("SIMPLE_PINHOLE", True, 3), ("OPENCV", False, 2),
    ("SIMPLE_RADIAL", True, 4)])
def test_colmap_loader_matches_jax(tmp_path, model, text, llffhold):
    write_colmap(tmp_path, np.random.default_rng(2), model, text=text)
    tcfg, jcfg = tload(), jload()
    tcfg.model.llffhold = jcfg.model.llffhold = llffhold
    got = tscene.load_scene(tcfg, str(tmp_path))
    want = jscene.load_scene(jcfg, str(tmp_path))
    assert_same_scene(got, want, "colmap")
    assert len(got.train_cameras) + len(got.test_cameras) == 9
    assert os.path.exists(tmp_path / "sparse" / "0" / "points3D.ply")
    no_eval = TC.load_colmap_scene(str(tmp_path), eval_split=False)
    assert len(no_eval.train_cameras) == 9 and not no_eval.test_cameras


def test_colmap_rejects_distorted_models(tmp_path):
    write_colmap(tmp_path, np.random.default_rng(3), "RADIAL", n=2)
    for load in (TC.load_colmap_scene, JC.load_colmap_scene):
        with pytest.raises(ValueError, match="unsupported COLMAP camera model RADIAL"):
            load(str(tmp_path))


def test_panoptic_loader_matches_jax(tmp_path):
    write_panoptic(tmp_path, np.random.default_rng(4))
    got = tscene.load_scene(tload(), str(tmp_path))
    want = JP.load_panoptic_scene(str(tmp_path))
    assert_same_scene(got, want, "PanopticSports")
    assert len(got.train_cameras) == 6 and got.maxtime == 3.0


@pytest.mark.parametrize("poses", [True, False], ids=["spiral", "no_video"])
def test_multipleview_loader_matches_jax(tmp_path, poses):
    write_multipleview(tmp_path, np.random.default_rng(5), poses=poses)
    got = tscene.load_scene(tload(), str(tmp_path))
    want = JMV.load_multipleview_scene(str(tmp_path))
    assert_same_scene(got, want, "MultipleView")
    # every frame trains; frames {0, n/3, 2n/3} of each camera also test
    assert len(got.train_cameras) == 15 and len(got.test_cameras) == 9
    assert len(got.video_cameras) == (300 if poses else 0)


@pytest.mark.parametrize("kind", ["MultipleView", "PanopticSports", "colmap"])
def test_phase_12_scenes_of_the_committed_frames(tmp_path, kind):
    """``chip_smoke.py`` phase 12 (b)'s scene writers on the committed
    frames: the loaders agree with JAX's, and rebuild the writer's cameras."""
    writer = {"MultipleView": CS.write_multipleview_scene,
              "PanopticSports": CS.write_panoptic_scene,
              "colmap": CS.write_colmap_scene}[kind]
    root = tmp_path / "scene"
    root.mkdir()
    writer(str(root))
    got = tscene.load_scene(tload(), str(root))
    assert_same_scene(got, jscene.load_scene(jload(), str(root)), kind)
    written = {(c, f): CS.jpeg_scene_camera(c, f)[0] for c in range(CS.JPEG_SCENE_CAMS)
               for f in range(CS.JPEG_SCENE_FRAMES)}
    for lc in got.train_cameras:
        path = lc.image.path
        if kind == "colmap":
            c, f = (int(x[1:]) for x in os.path.basename(path)[:-4].split("_")[1:])
        elif kind == "PanopticSports":
            c, f = int(os.path.basename(os.path.dirname(path))), int(os.path.basename(path)[:-4])
        else:
            c, f = int(os.path.dirname(path)[-2:]) - 1, int(os.path.basename(path)[6:-4]) - 1
        cam = written[(c, f)]
        for field in ("world_view", "full_proj", "camera_center"):
            np.testing.assert_allclose(getattr(lc.camera, field), getattr(cam, field),
                                       rtol=1e-6, atol=1e-6, err_msg=field)
        assert lc.camera.tanfovx == pytest.approx(cam.tanfovx, rel=1e-6)
        assert lc.camera.tanfovy == pytest.approx(cam.tanfovy, rel=1e-6)


def write_dynerf(root, rng):
    """``tests/test_loaders.py::TestDynerfScene``'s fixture."""
    poses = np.zeros((2, 3, 5))
    for i in range(2):
        poses[i, :, :3] = np.eye(3)
        poses[i, :, 3] = rng.normal(size=3)
        poses[i, :, 4] = [H, W, 40.0]
    np.save(root / "poses_bounds.npy", np.concatenate(
        [poses.reshape(2, -1), np.tile([[1.0, 10.0]], (2, 1))], axis=1))
    for c in range(2):
        d = root / f"cam{c:02d}" / "images"
        d.mkdir(parents=True)
        for f in range(3):
            Image.fromarray(rng.integers(0, 255, (H, W, 3), dtype=np.uint8)).save(
                d / f"{f:04d}.png")
    store_pointcloud(str(root / "points3D_downsample2.ply"),
                     rng.normal(size=(50, 3)).astype(np.float32), rng.uniform(0, 255, (50, 3)))


@pytest.mark.parametrize("kind", ["blender", "dynerf", "nerfies", "colmap", "PanopticSports",
                                  "MultipleView"])
def test_load_scene_dispatches_every_type(tmp_path, kind, monkeypatch):
    rng = np.random.default_rng(6)
    if kind == "blender":
        make_dnerf_dataset(tmp_path, n_train=3, n_test=1, size=W)
        monkeypatch.setattr(tscene, "TARGET_SIZE", (W, W))
    elif kind == "dynerf":
        write_dynerf(tmp_path, rng)
        monkeypatch.setattr(tscene, "DYNERF_SIZE", (W, H))
    elif kind == "nerfies":
        write_hypernerf(tmp_path, n=9)
    elif kind == "colmap":
        write_colmap(tmp_path, rng, n=4)
    elif kind == "PanopticSports":
        write_panoptic(tmp_path, rng, n_t=2)
    else:
        write_multipleview(tmp_path, rng, n_frames=3)
    assert tscene.sniff_dataset_type(str(tmp_path)) == jscene.sniff_dataset_type(
        str(tmp_path)) == kind
    got = tscene.load_scene(tload(), str(tmp_path))
    want = jscene.load_scene(jload(), str(tmp_path))
    assert got.dataset_type == want.dataset_type
    assert (len(got.train_cameras), len(got.test_cameras), len(got.video_cameras)) == \
        (len(want.train_cameras), len(want.test_cameras), len(want.video_cameras))
    assert got.maxtime == want.maxtime


def test_chip_smoke_jpeg_phase_on_cpu(capsys):
    """Phase 12 (b) on the CPU: the committed fixtures against their
    decodes, the MultipleView chain with the multipleview preset at a narrow
    width (every JPEG frame through the ref's decoder, counted), and the
    Panoptic and COLMAP scenes."""
    schedule = [o for o in NARROW if not o.startswith(("opt.", "tpu."))] + [
        "opt.coarse_iterations=2", "opt.iterations=3", "opt.position_lr_max_steps=3",
        "tpu.capacity=16384", "tpu.instance_budget=16384", "tpu.tile_budget=256",
        "tpu.blend_chunk=256"]
    res = CS.check_jpeg_path(torch.device("cpu"), schedule=schedule)
    out = capsys.readouterr().out
    assert res["cli"] == (0, 0)                                   # the plain path
    assert '"submitted": 5, "native": 0, "to_ref": 5' in out
    assert "max 0 levels, 1.000000 of the values exact" in out
    for kind in ("PanopticSports", "colmap"):
        assert f"    {kind}: load_scene" in out
