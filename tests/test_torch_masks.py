"""Covisible masks through the port's CLIs, against the JAX package's, and
``chip_smoke.py`` phase 12 (a) on the CPU.

The whole ``train_torch.py --debug_mode`` → ``render_torch.py`` →
``metrics_torch.py`` chain runs on a small portrait HyperNeRF scene
(``chip_smoke.write_hypernerf_scene``: 8 frames at 44×64, the val frames
with masks that are 0 over their right fifth) with the hypernerf preset
(``render_process`` on) at a narrow width, through
``chip_smoke.check_hypernerf_path``, whose checks pass. Then:

- the in-training eval's masked test PSNR (``eval_log.jsonl``) equals JAX's
  ``losses.masked_psnr`` on the same renders (the trained snapshot), GT and
  masks (read with Pillow);
- ``render_torch.py``'s ``masks/`` equal the source masks;
- ``metrics_torch.py``'s masked PSNR equals JAX's ``metrics.py`` on the same
  output tree, per view, and differs from the unmasked one.

Each port value is held within 1e-5 dB of JAX's ``masked_psnr`` evaluated
in float64 (``jax.enable_x64``) on the same inputs, and within 5e-5 dB of
JAX's float32 value. Both sides sum the squared errors in float32, in
another order (torch's pairwise sum, XLA's reduce), and JAX's float32 sum
strays up to 1.07e-5 dB from its float64 value (the first view here; the
port's 2.5e-7), so no bound of 1e-5 between the two float32 values holds.
:func:`test_float32_spread` holds both float32 values against the float64
one on 21 seeded views of 44×64 to 540×960 pixels: the port within 1e-5 dB,
JAX within 4e-5 dB, which gives the 5e-5 dB between them.
- a mask of another size is resized in ``render_torch.render_set`` as JAX
  resizes it with Pillow's BILINEAR, bit for bit.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke as CS
import metrics
import render_torch
from fourdgs_tpu.utils import losses as jlosses
from fourdgs_tpu_torch import scripts
from fourdgs_tpu_torch.configs.core import config_from_dict
from fourdgs_tpu_torch.data.scene import load_scene
from fourdgs_tpu_torch.ops import blend
from fourdgs_tpu_torch.render import CameraArrays, render
from fourdgs_tpu_torch.train import checkpoint
from fourdgs_tpu_torch.utils import losses as tlosses
from fourdgs_tpu_torch.utils import png
from tests.test_torch_cli import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_dynerf_cli import OVERRIDES as NARROW

FRAMES, IMAGE_SIZE = 8, (88, 128)          # 44×64 frames: 4 padding columns
COARSE, FINE = 2, 10
EXACT_DB, JAX32_DB = 1e-5, 4e-5           # port, JAX float32 against JAX float64
JAX_DB = EXACT_DB + JAX32_DB               # port against JAX float32 (docstring)


masked_psnr_jit = jax.jit(jlosses.masked_psnr)


def masked_psnr64(pred, gt, mask):
    """JAX's ``losses.masked_psnr`` in float64, compiled whole (in float64
    the sum's order moves it far less than the bounds): pred/gt [C, H, W],
    mask [H, W]."""
    with jax.enable_x64(True):
        return float(masked_psnr_jit(*(jnp.asarray(np.asarray(a, np.float64))
                                       for a in (pred, gt, mask))))


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    root = tmp_path_factory.mktemp("hypernerf")
    schedule = [o for o in NARROW if not o.startswith(("opt.", "tpu."))] + [
        f"opt.coarse_iterations={COARSE}", f"opt.iterations={FINE}",
        f"opt.position_lr_max_steps={FINE}", "tpu.capacity=16384",
        "tpu.instance_budget=16384", "tpu.tile_budget=256", "tpu.blend_chunk=256"]
    with pytest.MonkeyPatch.context() as mp:
        # one timed call each; K2's batch is read from its built library on the card
        for name in ("ITERS", "REPS", "WARMUP"):
            mp.setattr(scripts, name, 1)
        mp.setattr(blend, "k2_reduction",
                   lambda: {"batch": 3, "shuffles": 31, "unbatched": 50})
        res = CS.check_hypernerf_path(torch.device("cpu"), n_frames=FRAMES,
                                      image_size=IMAGE_SIZE, schedule=schedule, root=str(root))
    return res, str(root / "data"), str(root / "model")


def test_phase_runs_on_cpu(chain, capsys):
    res, data_dir, model_path = chain
    assert res["cli"] == (0, 0)                         # the plain path launches nothing
    assert res["padding"]["padding_pixels"] == 4 * 64   # 4 columns of the 48-wide grid
    assert np.isfinite(res["masked_psnr"]) and np.isfinite(res["blank_masked_psnr"])
    # render_process on the dense schedule (9), the debug panels every 100 (none)
    assert sorted(os.listdir(os.path.join(model_path, "train_render", "finetest"))) == \
        ["000009.png"]
    assert not os.path.exists(os.path.join(model_path, "debug_images"))


def _masked_test_views(model_path, data_dir):
    with open(os.path.join(model_path, "cfg_args.json")) as f:
        cfg = config_from_dict(json.load(f))
    data = load_scene(cfg, data_dir)
    lcs = data.test_cameras[::max(len(data.test_cameras) // 5, 1)][:5]
    assert lcs and all(lc.mask_path for lc in lcs)
    return cfg, lcs


def test_eval_masked_psnr_matches_jax(chain):
    _, data_dir, model_path = chain
    cfg, lcs = _masked_test_views(model_path, data_dir)
    state = checkpoint.load_snapshot(
        os.path.join(model_path, "point_cloud", f"iteration_{FINE}"), cfg, device="cpu")
    bg = torch.ones(3)
    want, exact = [], []
    for lc in lcs:
        cam = lc.camera
        with torch.no_grad():
            color = render(state.params, state, CameraArrays.from_camera(cam, device="cpu"),
                           cfg, cam.width, cam.height, "fine", bg, state.active_sh_degree,
                           device="cpu").color.numpy()
        gt = lc.image().astype(np.float32).transpose(2, 0, 1) / 255.0
        mask = np.asarray(Image.open(lc.mask_path).convert("L").resize(
            (cam.width, cam.height), Image.BILINEAR), np.float32)
        want.append(float(jlosses.masked_psnr(jnp.asarray(color), jnp.asarray(gt),
                                              jnp.asarray(mask))))
        exact.append(masked_psnr64(color, gt, mask))
    with open(os.path.join(model_path, "eval_log.jsonl")) as f:
        got = [json.loads(line) for line in f][-1]
    assert got["iteration"] == FINE
    assert got["test"]["psnr"] == pytest.approx(float(np.mean(exact)), abs=EXACT_DB)
    assert got["test"]["psnr"] == pytest.approx(float(np.mean(want)), abs=JAX_DB)


def test_render_writes_the_masks(chain):
    _, data_dir, model_path = chain
    base = os.path.join(model_path, "test", f"ours_{FINE}")
    _, lcs = _masked_test_views(model_path, data_dir)
    names = sorted(os.listdir(os.path.join(base, "masks")))
    assert names == sorted(os.listdir(os.path.join(base, "renders"))) == \
        [f"{i:05d}.png" for i in range(FRAMES // 2)]
    with open(os.path.join(data_dir, "dataset.json")) as f:
        val_ids = json.load(f)["val_ids"]
    for name, vid in zip(names, val_ids):
        got = np.asarray(Image.open(os.path.join(base, "masks", name)))
        want = np.asarray(Image.open(os.path.join(data_dir, "covisible", "2x", "val",
                                                  f"{vid}.png")).convert("L"))
        np.testing.assert_array_equal(got, want)
        assert (got == 0).any() and (got == 255).any()


def test_metrics_masked_psnr_matches_jax(chain, tmp_path):
    _, _, model_path = chain
    with open(os.path.join(model_path, "per_view.json")) as f:
        got = json.load(f)[f"ours_{FINE}"]["PSNR"]
    jax_tree = tmp_path / "jax_model"
    shutil.copytree(os.path.join(model_path, "test"), jax_tree / "test")
    metrics.evaluate([str(jax_tree)])
    with open(jax_tree / "per_view.json") as f:
        want = json.load(f)[f"ours_{FINE}"]["PSNR"]
    assert len(got) == len(want) == FRAMES // 2
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_DB)
    base = os.path.join(model_path, "test", f"ours_{FINE}")

    def read(sub, i, mode):
        return np.asarray(Image.open(os.path.join(base, sub, f"{i:05d}.png")).convert(mode),
                          np.float32)

    exact = [masked_psnr64(read("renders", i, "RGB").transpose(2, 0, 1) / 255.0,
                           read("gt", i, "RGB").transpose(2, 0, 1) / 255.0,
                           read("masks", i, "L")) for i in range(len(got))]
    np.testing.assert_allclose(got, exact, rtol=0, atol=EXACT_DB)
    shutil.rmtree(jax_tree / "test" / f"ours_{FINE}" / "masks")     # unmasked
    metrics.evaluate([str(jax_tree)])
    with open(jax_tree / "per_view.json") as f:
        unmasked = json.load(f)[f"ours_{FINE}"]["PSNR"]
    assert all(abs(a - b) > 1e-3 for a, b in zip(got, unmasked))


SPREAD_VIEWS = [(h, w, seed) for seed in range(7)
                for h, w in [(44, 64), (120, 160), (540, 960)]]


@pytest.mark.parametrize("h,w,seed", SPREAD_VIEWS)
def test_float32_spread(h, w, seed):
    """The port's and JAX's float32 masked PSNRs against JAX's float64 one,
    on a seeded view with noise of 10^-2.5 to 10^-0.5 over a mask that keeps
    40–95% of the pixels."""
    rng = np.random.default_rng([h, w, seed])
    gt = rng.random((3, h, w), dtype=np.float32)
    noise = rng.normal(0, 10 ** rng.uniform(-2.5, -0.5), gt.shape)
    pred = np.clip(gt + noise, 0, 1).astype(np.float32)
    mask = (rng.random((h, w)) > rng.uniform(0.05, 0.6)).astype(np.float32) * 255
    exact = masked_psnr64(pred, gt, mask)
    port = float(tlosses.masked_psnr(*(torch.from_numpy(a) for a in (pred, gt, mask))))
    # eagerly, as JAX's train.py and metrics.py call it
    jax32 = float(jlosses.masked_psnr(*(jnp.asarray(a) for a in (pred, gt, mask))))
    print(f"{h}x{w} seed {seed}: {exact:.4f} dB; port {port - exact:+.2e}, "
          f"JAX float32 {jax32 - exact:+.2e}")
    assert abs(port - exact) <= EXACT_DB
    assert abs(jax32 - exact) <= JAX32_DB
    assert abs(port - jax32) <= JAX_DB


def test_a_mask_of_another_size_raises(tmp_path):
    mask = tmp_path / "m.png"
    m = np.random.default_rng(4).integers(0, 2, (10, 12), dtype=np.uint8) * 255
    Image.fromarray(m).save(mask)
    cam = CS.jpeg_scene_camera(0, 0, size=(16, 10))[0]
    render_torch.render_set(str(tmp_path), "test", 1, [cam], None,
                            lambda c: torch.zeros(3, 10, 16), lambda: None, [str(mask)])
    # resized with BILINEAR, as JAX's render.py:42-43 does with Pillow
    np.testing.assert_array_equal(
        png.read_png(str(tmp_path / "test" / "ours_1" / "masks" / "00000.png")),
        np.asarray(Image.fromarray(m).resize((16, 10), Image.BILINEAR)))
