"""Port binning against ``bin_gaussians_fast`` on the same preprocess outputs
(JAX's, converted): every integer output exactly equal, also when the
instance demand exceeds the budget."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs_tpu.ops.binning import bin_gaussians_fast as jbin
from fourdgs_tpu.ops.preprocess import preprocess as jpreprocess
from fourdgs_tpu_torch.ops.binning import bin_gaussians_fast as tbin
from tests.test_math_core import look_at_camera
from tests.test_tiled_raster import random_scene


def _pre(n, seed, w=64, h=64):
    cam = look_at_camera([0.3, -0.2, -4], [0, 0, 0], width=w, height=h)
    p = random_scene(n, seed=seed, spread=1.2)
    alive = jnp.asarray(np.random.default_rng(seed).uniform(size=n) < 0.85)
    return jpreprocess(
        p["means3d"], p["scales"], p["rotations"], p["shs"],
        jnp.array(cam.camera_center), jnp.array(cam.world_view),
        jnp.array(cam.full_proj), cam.tanfovx, cam.tanfovy, w, h, 3,
        alive=alive, opacities=p["opacities"])


@pytest.mark.parametrize("budget_kind", ["fits", "overflows"])
def test_binning_matches_jax(budget_kind):
    pre = _pre(300, seed=11)
    demand = int(jnp.sum(pre.tiles_touched))
    K = 4096 if budget_kind == "fits" else 128 * (demand // 256)
    assert (demand <= K) == (budget_kind == "fits")
    j = jbin(pre.tile_min, pre.tile_max, pre.tiles_touched, pre.depths, 4, 4, K)
    t = tbin(*(torch.from_numpy(np.array(x)) for x in (
        pre.tile_min, pre.tile_max, pre.tiles_touched, pre.depths)), 4, 4, K)
    assert int(t.num_rendered) == int(j.num_rendered) == demand
    for name in ("gauss_id", "tile_id", "tile_start", "tile_stop", "slot",
                 "seg_starts", "seg_counts", "order"):
        np.testing.assert_array_equal(
            getattr(t, name).numpy(), np.asarray(getattr(j, name)), err_msg=name)
    assert t.tile_start.dtype == t.tile_stop.dtype == torch.int32
    if budget_kind == "overflows":
        # truncation: every slot is used, the last tiles end at K
        assert int(t.tile_stop.max()) == K
