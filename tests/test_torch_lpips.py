"""The port's LPIPS (``utils/lpips.py``) against the JAX package's, and the
LPIPS columns of ``metrics_torch.py``.

No pretrained weights are in the repository (``fourdgs_tpu/assets`` holds a
README), so the trunks are held to JAX's with random weights, the route of
``tests/test_lpips_parity.py``:

- ``random_weights(net, seed)`` gives JAX's arrays bit for bit, so one set
  of weights serves both sides;
- ``make_lpips`` equals JAX's ``make_lpips`` within 1e-5 for VGG16 and
  AlexNet, on single images and batches, at sizes whose pools floor;
- the ``.npz`` round trip of ``load_weights``, missing weights giving
  ``None`` and the weight search path being JAX's;
- ``metrics_torch.py`` writes null LPIPS columns without weights, as
  ``metrics.py`` does, and fills them with a weights directory the test
  writes, equal to the trunk's distance of each view.
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_torch
from fourdgs_tpu.utils import lpips as JL
from fourdgs_tpu_torch.utils import lpips as TL
from fourdgs_tpu_torch.utils import png
from tests.test_torch_cli import one_torch_thread  # noqa: F401  (autouse)

NETS = ("vgg", "alex")
TOL = 1e-5


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("net", NETS)
def test_random_weights_equal_jax(net, seed):
    got, want = TL.random_weights(net, seed), JL.random_weights(net, seed)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def pair(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.random(shape, dtype=np.float32)
    y = np.clip(x + rng.normal(0, 0.1, shape).astype(np.float32), 0, 1)
    return x, y


@pytest.mark.parametrize("shape", [(3, 64, 64), (3, 67, 45), (2, 3, 48, 40)],
                         ids=["64x64", "67x45", "batch2"])
@pytest.mark.parametrize("net", NETS)
def test_trunk_matches_jax(net, shape):
    w = JL.random_weights(net, seed=1)
    x, y = pair(shape, seed=len(shape) + shape[-1])
    want = float(JL.make_lpips(w, net)(jnp.asarray(x), jnp.asarray(y)))
    port = TL.make_lpips(TL.random_weights(net, seed=1), net, "cpu")
    got = port(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dim() == 0 and np.isfinite(want) and want > 0
    assert abs(float(got) - want) <= TOL, (float(got), want)
    # numpy inputs are taken too, and a pair of equal images is at 0
    assert float(port(x, y)) == float(got)
    assert float(port(x, x)) == 0.0


def test_layouts_and_missing_weights():
    assert TL._trunk_layout("vgg") == JL._trunk_layout("vgg")
    assert TL._trunk_layout("alex") == JL._trunk_layout("alex")
    with pytest.raises(ValueError, match="net must be"):
        TL._trunk_layout("squeeze")
    w = TL.random_weights("alex")
    del w["lin2_w"]
    with pytest.raises(KeyError, match="lin2_w"):
        TL.make_lpips(w, "alex", "cpu")


def test_weight_paths_and_npz_round_trip(tmp_path, monkeypatch):
    monkeypatch.delenv("FOURDGS_LPIPS_WEIGHTS_DIR", raising=False)
    for net in NETS:
        # JAX's search path, read as data from the JAX package's assets
        assert TL.default_weight_paths(net) == JL.default_weight_paths(net)
        assert TL.load_weights(net, str(tmp_path / "missing.npz")) is None
    monkeypatch.setenv("FOURDGS_LPIPS_WEIGHTS_DIR", str(tmp_path))
    assert TL.default_weight_paths("vgg") == JL.default_weight_paths("vgg")
    assert TL.load_weights("vgg") is None
    w = TL.random_weights("alex", seed=2)
    np.savez(tmp_path / "lpips_alex.npz", **w)
    back = TL.load_weights("alex")
    assert sorted(back) == sorted(w)
    for k in w:
        np.testing.assert_array_equal(back[k], w[k])
    assert TL.load_weights("vgg") is None


def write_renders(model_path, n=2, size=48):
    """A ``test/ours_1/{renders,gt}`` tree of ``n`` views."""
    rng = np.random.default_rng(5)
    base = os.path.join(model_path, "test", "ours_1")
    for d in ("renders", "gt"):
        os.makedirs(os.path.join(base, d))
    for i in range(n):
        gt = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        r = np.clip(gt.astype(int) + rng.integers(-30, 30, gt.shape), 0, 255).astype(np.uint8)
        png.write_png(os.path.join(base, "renders", f"{i:05d}.png"), r)
        png.write_png(os.path.join(base, "gt", f"{i:05d}.png"), gt)
    return base


def test_metrics_columns(tmp_path, monkeypatch):
    """Null without weights and without the external ``lpips`` package
    (made unimportable here); with weights, each view's LPIPS-alex equals
    JAX's trunk's distance of its PNGs, and LPIPS-vgg stays null without its
    file."""
    monkeypatch.setitem(sys.modules, "lpips", None)
    model = str(tmp_path / "model")
    base = write_renders(model)
    monkeypatch.setenv("FOURDGS_LPIPS_WEIGHTS_DIR", str(tmp_path / "none"))
    assert metrics_torch.try_lpips("cpu") is None
    res = metrics_torch.main(["--model_path", model, "--device", "cpu"])[model]["ours_1"]
    assert res["LPIPS-vgg"] is None and res["LPIPS-alex"] is None
    assert np.isfinite(res["PSNR"])

    wdir = tmp_path / "weights"
    wdir.mkdir()
    w = TL.random_weights("alex", seed=4)
    np.savez(wdir / "lpips_alex.npz", **w)
    monkeypatch.setenv("FOURDGS_LPIPS_WEIGHTS_DIR", str(wdir))
    nets = metrics_torch.try_lpips("cpu")
    assert sorted(nets) == ["alex"]
    res = metrics_torch.main(["--model_path", model, "--device", "cpu"])[model]["ours_1"]
    with open(os.path.join(model, "per_view.json")) as f:
        per_view = json.load(f)["ours_1"]
    jfn = JL.make_lpips(w, "alex")
    for i, got in enumerate(per_view["LPIPS-alex"]):
        r, g = (png.read_png(os.path.join(base, d, f"{i:05d}.png")).astype(np.float32)
                .transpose(2, 0, 1) / 255.0 for d in ("renders", "gt"))
        assert abs(got - float(jfn(jnp.asarray(r), jnp.asarray(g)))) <= TOL
    assert res["LPIPS-alex"] == pytest.approx(np.mean(per_view["LPIPS-alex"]))
    assert res["LPIPS-vgg"] is None and per_view["LPIPS-vgg"] == [None, None]
