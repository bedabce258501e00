"""The port's D-NeRF loader, scene, grid pruning and observability against
the JAX package's.

- ``load_blender_scene`` on ``tests/test_data.py::make_dnerf_dataset``, the
  same ``rng`` on both sides: cameras (matrices to 1e-6), uint8 frames bit
  for bit, the timeline, the init cloud, the normalization and the video
  cameras equal JAX's;
- ``sniff_dataset_type`` on the marker files of every dataset kind the JAX
  tests fabricate; ``load_scene`` of a marker alone fails as JAX's does;
- frames of another size are resized as JAX's are (RGBA, Pillow's BICUBIC,
  premultiplied), bit for bit; ``load_scene`` resizes to JAX's 800×800;
  ``build_scene`` from a seed or a ``torch.Generator``;
- ``grid_prune_pointcloud`` equals JAX's;
- ``log_scene_stats`` writes JAX's records.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

from fourdgs_tpu.configs.core import load_config as jload
from fourdgs_tpu.data import blender as jblender
from fourdgs_tpu.data import grid_pruning as jgp
from fourdgs_tpu.data import scene as jscene
from fourdgs_tpu.data.ply import PointCloud as JPointCloud
from fourdgs_tpu.utils import observability as jobs
from fourdgs_tpu_torch.configs.core import load_config as tload
from fourdgs_tpu_torch.data import blender as tblender
from fourdgs_tpu_torch.data import grid_pruning as tgp
from fourdgs_tpu_torch.data import scene as tscene
from fourdgs_tpu_torch.data.ply import PointCloud as TPointCloud
from fourdgs_tpu_torch.utils import observability as tobs
from fourdgs_tpu_torch.utils import png
from tests.test_data import make_dnerf_dataset
from tests.test_torch_cli import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("white", [True, False])
def test_blender_loader_matches_jax(tmp_path, white):
    make_dnerf_dataset(tmp_path, n_train=4, n_test=2, size=64)
    # an RGBA frame with partial alpha, so the compositing is exercised
    rgba = np.random.default_rng(9).integers(0, 256, (64, 64, 4), dtype=np.uint8)
    Image.fromarray(rgba, "RGBA").save(tmp_path / "train" / "r_1.png")
    kw = dict(white_background=white, target_size=(64, 64))
    want = jblender.load_blender_scene(str(tmp_path), rng=np.random.default_rng(3), **kw)
    got = tblender.load_blender_scene(str(tmp_path), rng=np.random.default_rng(3), **kw)
    assert got.dataset_type == want.dataset_type == "blender"
    assert got.maxtime == want.maxtime
    for split in ("train_cameras", "test_cameras"):
        g_split, w_split = getattr(got, split), getattr(want, split)
        assert len(g_split) == len(w_split) > 0
        for g, w in zip(g_split, w_split):
            np.testing.assert_array_equal(g.image, w.image)
            assert g.image.dtype == np.uint8
            for f in w.camera._fields:
                np.testing.assert_allclose(np.asarray(getattr(g.camera, f), np.float64),
                                           np.asarray(getattr(w.camera, f), np.float64),
                                           rtol=1e-6, atol=1e-6, err_msg=f)
    assert len(got.video_cameras) == len(want.video_cameras) == 160
    for g, w in zip(got.video_cameras[::40], want.video_cameras[::40]):
        np.testing.assert_allclose(g.full_proj, w.full_proj, rtol=1e-6, atol=1e-6)
        assert g.time == w.time
    for f in ("points", "colors", "normals"):
        np.testing.assert_array_equal(getattr(got.point_cloud, f),
                                      getattr(want.point_cloud, f))
    np.testing.assert_allclose(got.nerf_normalization["translate"],
                               want.nerf_normalization["translate"], rtol=1e-12)
    assert got.nerf_normalization["radius"] == pytest.approx(
        want.nerf_normalization["radius"], rel=1e-12)
    # another size: both resize the RGBA frames (the partial-alpha one too)
    kw["target_size"] = (80, 72)
    want = jblender.load_blender_scene(str(tmp_path), rng=np.random.default_rng(3), **kw)
    got = tblender.load_blender_scene(str(tmp_path), rng=np.random.default_rng(3), **kw)
    for g, w in zip(got.train_cameras + got.test_cameras,
                    want.train_cameras + want.test_cameras):
        assert g.image.shape == (72, 80, 3)
        np.testing.assert_array_equal(g.image, w.image)
        assert (g.camera.width, g.camera.height) == (w.camera.width, w.camera.height)


MARKERS = {
    "colmap": ("sparse/0", None),
    "blender": ("transforms_train.json", "{}"),
    "dynerf": ("poses_bounds.npy", ""),
    "nerfies": ("dataset.json", "{}"),
    "PanopticSports": ("train_meta.json", "{}"),
    "MultipleView": ("points3D_multipleview.ply", ""),
}


@pytest.mark.parametrize("kind", sorted(MARKERS))
def test_sniff_and_unported_loaders(tmp_path, kind):
    name, body = MARKERS[kind]
    path = tmp_path / name
    if body is None:
        path.mkdir(parents=True)
    else:
        path.write_text(body)
    assert tscene.sniff_dataset_type(str(tmp_path)) == \
        jscene.sniff_dataset_type(str(tmp_path)) == kind
    if kind == "dynerf":      # ported: the empty marker holds no poses array
        with pytest.raises(EOFError):
            tscene.load_scene(tload(), str(tmp_path))
    elif kind != "blender":
        # ported (tests/test_torch_hypernerf.py, tests/test_torch_colmap.py):
        # a marker alone fails as JAX's loader fails on it
        with pytest.raises(Exception) as want:
            jscene.load_scene(jload(), str(tmp_path))
        with pytest.raises(want.type):
            tscene.load_scene(tload(), str(tmp_path))
    (tmp_path / "sparse").mkdir(exist_ok=True)   # colmap's marker comes first
    assert tscene.sniff_dataset_type(str(tmp_path)) == \
        jscene.sniff_dataset_type(str(tmp_path)) == "colmap"


def test_sniff_rejects_an_unknown_directory(tmp_path):
    for sniff in (tscene.sniff_dataset_type, jscene.sniff_dataset_type):
        with pytest.raises(ValueError, match="could not recognize"):
            sniff(str(tmp_path))


def test_build_scene(tmp_path, monkeypatch):
    make_dnerf_dataset(tmp_path, n_train=4, n_test=2, size=64)
    cfg = tload()
    # JAX's frame size unless told otherwise: 64×64 frames are resized to it
    assert tscene.load_scene(cfg, str(tmp_path)).train_cameras[0].image.shape == (800, 800, 3)
    monkeypatch.setattr(tscene, "TARGET_SIZE", (64, 64))
    data = tscene.load_scene(cfg, str(tmp_path))
    assert data.train_cameras[0].image.shape == (64, 64, 3)
    assert data.video_cameras[0].width == 64
    for seed in (5, torch.Generator().manual_seed(0)):
        s = tscene.build_scene(cfg, seed, scene_data=data, device="cpu")
        assert s.cameras_extent == data.nerf_normalization["radius"]
        assert int(s.state.alive.sum()) == 2000
        np.testing.assert_array_equal(s.state.params["xyz"][:2000].numpy(),
                                      data.point_cloud.points)
        assert s.state.spatial_lr_scale == s.cameras_extent


@pytest.mark.parametrize("with_cameras", [True, False])
def test_grid_pruning_matches_jax(tmp_path, with_cameras):
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (3000, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (3000, 3)).astype(np.float32)
    normals = rng.normal(size=(3000, 3)).astype(np.float32)
    data = None
    if with_cameras:
        make_dnerf_dataset(tmp_path, n_train=4, n_test=2, size=64)
        data = jblender.load_blender_scene(str(tmp_path), target_size=(64, 64),
                                           rng=np.random.default_rng(0))
    got = tgp.grid_prune_pointcloud(TPointCloud(pts, cols, normals), data)
    want = jgp.grid_prune_pointcloud(JPointCloud(pts, cols, normals), data)
    assert 0 < len(got.points) < 3000
    for f in ("points", "colors", "normals"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def test_scene_stats_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    P = 300
    fields = dict(params={"opacity": rng.normal(size=(P, 1)).astype(np.float32)},
                  alive=rng.uniform(size=P) < 0.8,
                  deformation_accum=rng.uniform(0, 1, (P, 3)).astype(np.float32),
                  deformation_table=rng.uniform(size=P) < 0.5)
    js = SimpleNamespace(**fields)
    ts = SimpleNamespace(params={"opacity": torch.from_numpy(fields["params"]["opacity"])},
                         **{k: torch.from_numpy(v) for k, v in fields.items()
                            if k != "params"})
    jev, tev = jobs.EventLog(str(tmp_path / "j")), tobs.EventLog(str(tmp_path / "t"))
    jobs.log_scene_stats(jev, js, "fine", 7)
    tobs.log_scene_stats(tev, ts, "fine", 7)
    img = rng.uniform(0, 1, (3, 8, 8))
    jev.add_image("fine/test_view_0/render", img, 7)
    tev.add_image("fine/test_view_0/render", img, 7)
    jev.close()
    tev.close()
    want, got = jobs.read_events(str(tmp_path / "j")), tobs.read_events(str(tmp_path / "t"))
    assert [r["tag"] for r in got] == [r["tag"] for r in want]
    for g, w in zip(got, want):
        if "scalar" in w:
            assert g["scalar"] == pytest.approx(w["scalar"], rel=1e-6)
        else:
            assert g["hist"]["counts"] == w["hist"]["counts"]
            np.testing.assert_allclose(g["hist"]["edges"], w["hist"]["edges"],
                                       rtol=1e-5, atol=1e-6)
    name = "eval_images/fine_test_view_0_render_000007.png"
    with Image.open(tmp_path / "j" / name) as im:
        np.testing.assert_array_equal(png.read_png(str(tmp_path / "t" / name)),
                                      np.asarray(im))
