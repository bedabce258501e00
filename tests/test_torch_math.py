"""Port math core against the JAX package on the same numpy inputs: SH,
quaternions, preprocess, plus the port's own copies of the config loader,
camera math and PLY I/O."""

import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs_tpu.configs import core as jcore
from fourdgs_tpu.data import ply as jply
from fourdgs_tpu.ops.preprocess import preprocess as jpreprocess
from fourdgs_tpu.utils import quaternion as jquat
from fourdgs_tpu.utils import sh as jsh
from fourdgs_tpu_torch.configs import core as tcore
from fourdgs_tpu_torch.data import ply as tply
from fourdgs_tpu_torch.ops.preprocess import preprocess as tpreprocess
from fourdgs_tpu_torch.utils import graphics as tgraphics
from fourdgs_tpu_torch.utils import quaternion as tquat
from fourdgs_tpu_torch.utils import sh as tsh
from tests.test_math_core import look_at_camera
from tests.test_tiled_raster import random_scene

ROOT = pathlib.Path(__file__).resolve().parent.parent
PRESETS = ROOT / "fourdgs_tpu" / "configs" / "presets"


@pytest.fixture(autouse=True, scope="module")
def warm_cpu_math():
    """Run each vectorized transcendental once before any comparison. On the
    CPU build of PyTorch, the first such call of a process has been seen to
    compute one worker thread's share of the tensor inaccurately (``exp`` off
    by 1.5e-4 relative in about 5% of fresh processes, whatever the ISA
    level); every later call agrees with float64 to 1 ulp."""
    x = torch.rand(1 << 18) + 0.5
    for f in (torch.exp, torch.log, torch.sqrt, torch.sigmoid):
        f(x)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_sh_to_rgb(deg):
    rng = np.random.default_rng(deg)
    sh = rng.uniform(-1, 1, (200, 16, 3)).astype(np.float32)
    d = rng.normal(size=(200, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    want = np.asarray(jsh.sh_to_rgb(deg, jnp.asarray(sh), jnp.asarray(d)))
    got = tsh.sh_to_rgb(deg, _t(sh), _t(d)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    rgb = rng.uniform(0, 1, (50, 3)).astype(np.float32)
    np.testing.assert_allclose(tsh.rgb_to_sh(_t(rgb)).numpy(),
                               np.asarray(jsh.rgb_to_sh(jnp.asarray(rgb))),
                               rtol=1e-6, atol=1e-7)


def test_quaternion_ops():
    rng = np.random.default_rng(1)
    q1 = rng.normal(size=(300, 4)).astype(np.float32)
    q2 = rng.normal(size=(300, 4)).astype(np.float32)
    s = rng.uniform(0.01, 2.0, (300, 3)).astype(np.float32)
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tquat.normalize(_t(q1)).numpy(),
                               np.asarray(jquat.normalize(q1)), **tol)
    np.testing.assert_allclose(tquat.to_rotation_matrix(_t(q1)).numpy(),
                               np.asarray(jquat.to_rotation_matrix(q1)), **tol)
    np.testing.assert_allclose(tquat.multiply(_t(q1), _t(q2)).numpy(),
                               np.asarray(jquat.multiply(q1, q2)), **tol)
    qn = np.asarray(jquat.normalize(q1))
    np.testing.assert_allclose(
        tquat.covariance_vec6(_t(s), _t(qn), 1.3).numpy(),
        np.asarray(jquat.covariance_vec6(s, qn, 1.3)), **tol)


@pytest.mark.parametrize("size,seed", [((64, 64), 3), ((48, 80), 4)])
def test_preprocess(size, seed):
    w, h = size
    cam = look_at_camera([0.3, -0.2, -4], [0, 0, 0], width=w, height=h)
    p = random_scene(300, seed=seed, spread=1.5)
    alive = np.random.default_rng(seed).uniform(size=300) < 0.9
    q = np.asarray(p["rotations"])
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    args_np = [np.asarray(p["means3d"]), np.asarray(p["scales"]), q,
               np.asarray(p["shs"]), cam.camera_center, cam.world_view,
               cam.full_proj]
    j = jpreprocess(*map(jnp.asarray, args_np), cam.tanfovx, cam.tanfovy,
                    w, h, 3, alive=jnp.asarray(alive),
                    opacities=p["opacities"])
    t = tpreprocess(*map(_t, args_np), torch.tensor(cam.tanfovx, dtype=torch.float32),
                    torch.tensor(cam.tanfovy, dtype=torch.float32), w, h, 3,
                    opacities=_t(np.asarray(p["opacities"])), alive=_t(alive))
    for name in ("means2d", "depths", "conic", "rgb"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    for name in ("radii", "tile_min", "tile_max", "tiles_touched"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), err_msg=name)
    assert int(t.tiles_touched.sum()) > 0


@pytest.mark.parametrize("preset", ["dnerf/lego.py", "dynerf/default.py",
                                    "hypernerf/default.py"])
def test_load_config_matches_jax(preset):
    path = PRESETS / preset
    assert (dataclasses.asdict(tcore.load_config(path))
            == dataclasses.asdict(jcore.load_config(path)))


def test_lego_preset_takes_the_ported_path():
    cfg = tcore.load_config(PRESETS / "dnerf" / "lego.py")
    assert cfg.tpu.backend == "pallas"
    assert not cfg.tpu.payload_bf16 and not cfg.tpu.ellipse_tile_cull
    assert cfg.hidden.multires == (1, 2) and cfg.hidden.defor_depth == 0
    assert cfg.model.sh_degree == 3 and cfg.model.white_background


def test_graphics_and_ply_copies(tmp_path):
    from fourdgs_tpu.utils import graphics as jgraphics

    R = np.linalg.qr(np.random.default_rng(0).normal(size=(3, 3)))[0]
    t = np.array([0.1, -0.3, 3.0])
    a = jgraphics.make_camera(R, t, 1.0, 0.8, 64, 48, time=0.25)
    b = tgraphics.make_camera(R, t, 1.0, 0.8, 64, 48, time=0.25)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))

    rng = np.random.default_rng(2)
    n = 20
    params = {"xyz": rng.normal(size=(n, 3)), "f_dc": rng.normal(size=(n, 3)),
              "f_rest": rng.normal(size=(n, 45)), "scaling": rng.normal(size=(n, 3)),
              "rotation": rng.normal(size=(n, 4)), "opacity": rng.normal(size=(n, 1))}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    alive = rng.uniform(size=n) < 0.7
    tply.save_gaussian_ply(str(tmp_path / "t.ply"), params, alive)
    back = jply.load_gaussian_ply(str(tmp_path / "t.ply"))
    for k, v in back.items():
        np.testing.assert_array_equal(v, params[k][alive], err_msg=k)
