"""A Blender scene's random init cloud is seeded in the port.

Without a ``fused.ply`` the Blender loader draws 2,000 random points; JAX's
``build_scene`` gives the loader no generator, so two runs of one schedule
start from different clouds (a fault of the reference the port no longer
copies). The port's ``build_scene(cfg, seed)`` (which ``train_torch.py
--seed`` calls) passes ``np.random.default_rng(seed)`` to the loader: one
seed gives one cloud, another seed another, and the cloud equals the one
JAX's loader draws when it is given the same generator.
"""

import numpy as np

from fourdgs_tpu.data import blender as jblender
from fourdgs_tpu_torch.configs.core import load_config
from fourdgs_tpu_torch.data import scene as tscene
from tests.test_data import make_dnerf_dataset
from tests.test_torch_cli import one_torch_thread  # noqa: F401  (autouse)


def test_seed_fixes_the_init_cloud(tmp_path, monkeypatch):
    monkeypatch.setattr(tscene, "TARGET_SIZE", (64, 64))
    make_dnerf_dataset(tmp_path, n_train=2, n_test=1, size=64)
    cfg = load_config()
    cfg.model.source_path = str(tmp_path)

    def cloud(seed):
        s = tscene.build_scene(cfg, seed, device="cpu")
        pts = s.data.point_cloud.points
        np.testing.assert_array_equal(s.state.params["xyz"][:len(pts)].numpy(), pts)
        return pts, s.data.point_cloud.colors

    (p7, c7), (p7b, c7b), (p8, _) = cloud(7), cloud(7), cloud(8)
    assert p7.shape == (2000, 3)
    np.testing.assert_array_equal(p7, p7b)
    np.testing.assert_array_equal(c7, c7b)
    assert not np.array_equal(p7, p8)
    want = jblender.load_blender_scene(str(tmp_path), target_size=(64, 64),
                                       rng=np.random.default_rng(7)).point_cloud
    np.testing.assert_array_equal(p7, want.points)
    np.testing.assert_array_equal(c7, want.colors)
    # load_scene without a generator still draws an unseeded cloud, as JAX's
    unseeded = [tscene.load_scene(cfg).point_cloud.points for _ in range(2)]
    assert not np.array_equal(*unseeded)
