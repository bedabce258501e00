"""Lazy GT frames in ``train/loop.py::scene_reconstruction``: the same
stage trained on in-memory uint8 arrays (cached on the device, pre-tiled),
on path-backed ``data/dynerf.py::ImageRef`` frames (decoded per batch by the
native prefetcher, batch t + 1 submitted while step t runs) and on callables
without a path (called per batch) ends in the same state, leaf for leaf and
bit for bit, with the same logged loss and PSNR: the GT pixels and the
batches are the same, and the tile-space loss reads them the same way. The
frames are 72×56 (a padded tile grid), the batch 2; capacity growth,
densification and the opacity reset fire. Lazy frames are never stacked or
cached: the prefetcher counts one submission per frame of every batch, and
the JAX chunk rule (``scan_steps``) stays with the device cache."""

import functools
import math

import numpy as np
import pytest
import torch

from fourdgs_tpu_torch.data.dynerf import ImageRef
from fourdgs_tpu_torch.models import gaussians as TG
from fourdgs_tpu_torch.train import adam as tadam
from fourdgs_tpu_torch.train import loop as tloop
from fourdgs_tpu_torch.utils import png
from tests.test_torch_loop import _port_cfg
from tests.test_torch_cli import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_train import _camera

W, H, N_CAMS, ITERS = 72, 56, 6, 7


class CallOnly:
    """A lazy frame without a path: the loop must call it."""

    def __init__(self, img):
        self.img, self.calls = img, 0

    def __call__(self):
        self.calls += 1
        return self.img

    @property
    def shape(self):
        return self.img.shape

    @property
    def ndim(self):
        return 3


@functools.cache
def _frames(root):
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, (N_CAMS, H, W, 3), dtype=np.uint8)
    paths = []
    for i, img in enumerate(imgs):
        paths.append(f"{root}/f{i}.png")
        png.write_png(paths[-1], img, filter_type=i % 5)
    return imgs, paths


def _train(gts, scan_steps=1):
    """One fine stage of ``ITERS`` steps from the same init; returns
    (state, Adam state, log)."""
    cfg = _port_cfg()
    cfg.tpu.scan_steps = scan_steps
    cfg.tpu.capacity, cfg.tpu.capacity_init = 256, 64
    cfg.tpu.instance_budget = 4096
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.8, 0.8, (40, 3)).astype(np.float32)
    state = TG.create_from_pcd(cfg, pts, rng.uniform(0, 1, (40, 3)).astype(np.float32),
                               3.0, seed=0, device="cpu")
    cams = [(_camera(i % 3, W, H, time=0.1 * i), g) for i, g in enumerate(gts)]
    return tloop.scene_reconstruction(cfg, state, tadam.init(state.params), cams, "fine",
                                      ITERS, 3.0, log_interval=2, device="cpu")


@functools.cache
def _runs(root):
    imgs, paths = _frames(root)
    call_only = [CallOnly(g) for g in imgs]
    runs = {"arrays": _train(list(imgs)),
            "refs": _train([ImageRef(p, (W, H)) for p in paths]),
            "callables": _train(call_only)}
    return runs, [c.calls for c in call_only]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _runs(str(tmp_path_factory.mktemp("lazy")))


def _leaves(state, opt):
    out = [(f"params.{n}", x) for n, x in tadam.named_leaves(state.params)]
    out += [(f, getattr(state, f)) for f in ("alive", "max_radii2d", "xyz_gradient_accum",
                                             "denom", "deformation_accum",
                                             "deformation_table")]
    out += [(f"mu.{n}", x) for n, x in tadam.named_leaves(opt.mu)]
    return out + [(f"nu.{n}", x) for n, x in tadam.named_leaves(opt.nu)]


@pytest.mark.parametrize("lazy", ["refs", "callables"])
def test_lazy_frames_train_as_arrays(runs, lazy):
    (want_s, want_o, want_log), (got_s, got_o, got_log) = runs[0]["arrays"], runs[0][lazy]
    for (name, g), (_, w) in zip(_leaves(got_s, got_o), _leaves(want_s, want_o)):
        assert torch.equal(g, w), name
    assert [e["iter"] for e in got_log.iterations] == [2, 4, 6, 7]
    for g, w in zip(got_log.iterations, want_log.iterations):
        for k in ("loss", "l1", "psnr", "n_points", "num_rendered"):
            assert g[k] == w[k], (k, g, w)
        assert math.isfinite(g["loss"])
    assert [e["kind"] for e in got_log.events] == [e["kind"] for e in want_log.events]


def test_prefetcher_counts_and_calls(runs):
    """The refs went through the prefetcher, one submission per frame of
    every batch, all decoded natively; the callables were called as many
    times; the arrays' run used neither."""
    result, calls = runs
    frames = ITERS * 2
    assert result["refs"][2].prefetch == {"submitted": frames, "native": frames, "to_ref": 0}
    assert result["arrays"][2].prefetch is None and result["callables"][2].prefetch is None
    assert sum(calls) == frames


def test_scan_chunks_stay_with_the_device_cache(tmp_path):
    """With ``scan_steps`` 4 the cached arrays' log reads JAX's chunk max of
    ``num_rendered`` (at least the step's own), the lazy run each step's
    own: the parameters still agree bit for bit."""
    imgs, paths = _frames(str(tmp_path))
    a_s, a_o, a_log = _train(list(imgs), scan_steps=4)
    r_s, r_o, r_log = _train([ImageRef(p, (W, H)) for p in paths], scan_steps=4)
    for (name, g), (_, w) in zip(_leaves(r_s, r_o), _leaves(a_s, a_o)):
        assert torch.equal(g, w), name
    lazy_nr = [e["num_rendered"] for e in r_log.iterations]
    cached_nr = [e["num_rendered"] for e in a_log.iterations]
    assert all(c >= g for c, g in zip(cached_nr, lazy_nr)) and cached_nr != lazy_nr
