"""The port's copies of the Nerfies camera (``data/nerfies_camera.py``) and
the pose smoothing (``utils/pose_utils.py``) against the JAX package's.

Random distorted cameras, built as ``tests/test_nerfies_camera.py`` builds
its camera (a rotation about y, an off-centre principal point, mild radial
and tangential distortion), with every parameter drawn from a seed: every
method (``from_json``, ``to_json``, ``project``, ``pixel_to_local_rays``,
``pixels_to_rays``, ``pixels_to_points``, ``get_pixel_centers``, ``scale``)
and ``undistort`` equal JAX's within 1e-12 (both are float64 numpy), and
``smooth_camera_poses`` over random key poses likewise."""

import json

import numpy as np
import pytest

from fourdgs_tpu.data import nerfies_camera as JN
from fourdgs_tpu.utils import pose_utils as JP
from fourdgs_tpu_torch.data import nerfies_camera as TN
from fourdgs_tpu_torch.utils import pose_utils as TP

TOL = dict(rtol=1e-12, atol=1e-12)


def rotation(rng):
    q = rng.normal(size=4)
    return JP.quaternion_to_rotation_matrix(q / np.linalg.norm(q))


def camera_json(seed, distorted=True):
    rng = np.random.default_rng(seed)
    w, h = int(rng.integers(320, 800)), int(rng.integers(240, 600))
    return {
        "orientation": rotation(rng).tolist(),
        "position": rng.normal(0, 2, 3).tolist(),
        "focal_length": float(rng.uniform(300, 900)),
        "principal_point": [float(w / 2 + rng.normal(0, 10)),
                            float(h / 2 + rng.normal(0, 10))],
        "image_size": [w, h],
        "skew": float(rng.normal(0, 0.5)),
        "pixel_aspect_ratio": float(rng.uniform(0.95, 1.05)),
        "radial_distortion": ([float(rng.uniform(-0.15, -0.05)),
                               float(rng.uniform(0, 0.04)),
                               float(rng.uniform(-1e-3, 1e-3))]
                              if distorted else [0.0, 0.0, 0.0]),
        "tangential_distortion": ([float(rng.normal(0, 1e-3)), float(rng.normal(0, 1e-3))]
                                  if distorted else [0.0, 0.0]),
    }


@pytest.fixture(params=[(0, True), (1, True), (2, False), (3, True)],
                ids=["d0", "d1", "pinhole", "d3"])
def cams(request, tmp_path):
    seed, distorted = request.param
    path = tmp_path / "cam.json"
    path.write_text(json.dumps(camera_json(seed, distorted)))
    return JN.NerfiesCamera.from_json(str(path)), TN.NerfiesCamera.from_json(str(path)), seed


def test_json_and_geometry(cams, tmp_path):
    j, t, _ = cams
    assert t.to_json() == j.to_json()
    for attr in ("optical_axis", "translation"):
        np.testing.assert_allclose(getattr(t, attr), getattr(j, attr), **TOL)
    assert t.has_distortion == j.has_distortion
    old = dict(j.to_json())
    old["tangential"] = old.pop("tangential_distortion")   # the old key
    (tmp_path / "old.json").write_text(json.dumps(old))
    assert (TN.NerfiesCamera.from_json(str(tmp_path / "old.json")).to_json()
            == JN.NerfiesCamera.from_json(str(tmp_path / "old.json")).to_json())


def test_every_method_matches(cams):
    j, t, seed = cams
    rng = np.random.default_rng(100 + seed)
    w, h = j.image_size
    pix = np.stack([rng.uniform(0, w, (7, 5)), rng.uniform(0, h, (7, 5))], axis=-1)
    depth = rng.uniform(0.5, 5.0, (7, 5))
    pts = rng.normal(0, 1, (11, 3)) + j.position + 3 * j.optical_axis
    for name, args in (("project", (pts,)), ("pixel_to_local_rays", (pix,)),
                       ("pixels_to_rays", (pix,)), ("pixels_to_points", (pix, depth)),
                       ("get_pixel_centers", ())):
        got, want = getattr(t, name)(*args), getattr(j, name)(*args)
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)
    for factor in (0.5, 2.0, 0.25):
        assert t.scale(factor).to_json() == j.scale(factor).to_json()
    with pytest.raises(ValueError):
        t.scale(0.0)


def test_undistort_matches():
    rng = np.random.default_rng(7)
    xd, yd = rng.uniform(-0.5, 0.5, (2, 300))
    coeffs = (-0.12, 0.03, 0.001, 1e-3, -5e-4)
    for it in (1, 3, 10):
        got = TN.undistort(xd, yd, *coeffs, iterations=it)
        want = JN.undistort(xd, yd, *coeffs, iterations=it)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_allclose(TN._distort(xd, yd, *coeffs), JN._distort(xd, yd, *coeffs),
                               **TOL)


@pytest.mark.parametrize("n_keys,n_interp", [(2, 10), (5, 5), (9, 10)])
def test_smooth_camera_poses_matches(n_keys, n_interp):
    rng = np.random.default_rng(n_keys)
    Rs = [rotation(rng) for _ in range(n_keys)]
    ps = [rng.normal(0, 1, 3) for _ in range(n_keys)]
    got = TP.smooth_camera_poses(Rs, ps, num_interpolations=n_interp)
    want = JP.smooth_camera_poses(Rs, ps, num_interpolations=n_interp)
    assert [len(x) for x in got] == [len(x) for x in want]
    for g_list, w_list in zip(got, want):
        for g, w in zip(g_list, w_list):
            np.testing.assert_allclose(g, w, **TOL)
    for R in Rs:    # the quaternion helpers
        q = TP.rotation_matrix_to_quaternion(R)
        np.testing.assert_allclose(q, JP.rotation_matrix_to_quaternion(R), **TOL)
        np.testing.assert_allclose(TP.quaternion_to_rotation_matrix(q),
                                   JP.quaternion_to_rotation_matrix(q), **TOL)
