"""The port's Pillow-exact resample (``utils/resample.py`` over
``native/resample.cpp``, built here with ``g++``) against Pillow's
``Image.resize``, and the loaders that resize with it against JAX's.

- ``resize`` equals ``np.asarray(Image.fromarray(img).resize(size, F))``
  exactly, for L, RGB and RGBA (Pillow resamples RGBA premultiplied, and so
  does the port: no level differs, so no bound is set) with BILINEAR,
  BICUBIC and LANCZOS: downscale and upscale, odd and prime sizes, one axis
  only, 1×N and N×1, and the factor of 2 from the capture size 2704×2028 to
  DyNeRF's 1352×1014 on one frame. A frame of its own size is returned
  unchanged, as Pillow returns a copy.
- Pillow's ``box``, ``reducing_gap`` and its other filters raise
  ``NotImplementedError`` by name; a bad image raises ``ValueError``.
- The committed fixtures of ``tests/torch_fixtures/resample`` (inputs and
  Pillow's outputs in one ``.npz``, for the card, whose host the port may
  not ask Pillow) against the port, and :func:`write_committed_fixtures`,
  which wrote them.
- The loaders take frames of another size as JAX's do, on the same files:
  ``ImageRef`` (PNG and JPEG, LANCZOS), a Blender RGBA frame (BICUBIC,
  premultiplied, before the background composite) and a HyperNeRF covisible
  mask (BILINEAR in mode L, JAX's ``train.py:193-194``).
- The resampler is built with its flags and links nothing.
"""

import os
import zipfile

import numpy as np
import pytest
from PIL import Image

import chip_smoke as CS
from fourdgs_tpu.data import blender as jblender
from fourdgs_tpu.data.dynerf import ImageRef as JImageRef
from fourdgs_tpu_torch.data import blender as tblender
from fourdgs_tpu_torch.data.dynerf import ImageRef
from fourdgs_tpu_torch.data.hypernerf import read_mask
from fourdgs_tpu_torch.utils import native, png, resample
from fourdgs_tpu_torch.utils.resample import resize
from tests.test_torch_jpeg import make_image

PIL_FILTERS = {"bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC,
               "lanczos": Image.LANCZOS}
MODES = {1: "L", 3: "RGB", 4: "RGBA"}
# (W, H) → (W', H'): down, up, both ways at prime sizes, one axis, 1×N and
# N×1, a factor of 2, a slight change
SIZES = [((37, 23), (16, 11)), ((11, 7), (37, 23)), ((31, 17), (13, 29)),
         ((48, 32), (48, 13)), ((48, 32), (19, 32)), ((1, 29), (1, 7)),
         ((29, 1), (7, 1)), ((7, 1), (29, 3)), ((38, 26), (19, 13)),
         ((30, 30), (29, 31))]


def sample_image(w, h, channels, seed=0):
    """:func:`make_image` with, for RGBA, an alpha channel holding 0, 255 and
    partial values."""
    img = make_image(w, h, channels=min(channels, 3), seed=seed)
    if channels != 4:
        return img
    alpha = np.random.default_rng(seed + 100).integers(0, 256, (h, w), dtype=np.uint8)
    alpha[: h // 3] = 255
    alpha[h // 3: h // 2] = 0
    return np.concatenate([img, alpha[:, :, None]], axis=2)


def pillow(img, size, flt):
    return np.asarray(Image.fromarray(img, MODES[1 if img.ndim == 2 else img.shape[2]])
                      .resize(size, PIL_FILTERS[flt]))


def case_name(channels, src, dst):
    return f"{MODES[channels].lower()}_{src[0]}x{src[1]}_{dst[0]}x{dst[1]}"


@pytest.mark.parametrize("flt", sorted(PIL_FILTERS))
@pytest.mark.parametrize("channels", sorted(MODES), ids=lambda c: MODES[c])
@pytest.mark.parametrize("src,dst", SIZES,
                         ids=[f"{s[0]}x{s[1]}-{d[0]}x{d[1]}" for s, d in SIZES])
def test_matches_pillow(src, dst, channels, flt):
    img = sample_image(*src, channels, seed=src[0] * 7 + src[1])
    got = resize(img, dst, flt)
    want = pillow(img, dst, flt)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_factor_two_at_capture_size():
    """One 2704×2028 frame to DyNeRF's 1352×1014, LANCZOS (JAX's
    ``ImageRef``)."""
    img = make_image(2704, 2028, seed=11)
    np.testing.assert_array_equal(resize(img, (1352, 1014), "lanczos"),
                                  pillow(img, (1352, 1014), "lanczos"))


@pytest.mark.parametrize("channels", sorted(MODES), ids=lambda c: MODES[c])
def test_same_size_is_unchanged(channels):
    """Pillow returns a copy, not a premultiplied round trip of RGBA."""
    img = sample_image(19, 13, channels, seed=3)
    for flt in PIL_FILTERS:
        got = resize(img, (19, 13), flt)
        np.testing.assert_array_equal(got, img)
        np.testing.assert_array_equal(got, pillow(img, (19, 13), flt))
        assert got is not img


@pytest.mark.parametrize("kwargs,match", [
    (dict(flt="nearest"), "filter 'nearest'"), (dict(flt="box"), "filter 'box'"),
    (dict(flt="hamming"), "filter 'hamming'"), (dict(box=(0, 0, 4, 4)), "box"),
    (dict(reducing_gap=2.0), "reducing_gap")])
def test_unported_options_raise(kwargs, match):
    img = sample_image(8, 8, 3)
    flt = kwargs.pop("flt", "bilinear")
    with pytest.raises(NotImplementedError, match=match):
        resize(img, (4, 4), flt, **kwargs)


@pytest.mark.parametrize("img,size", [
    (np.zeros((4, 4), np.float32), (2, 2)), (np.zeros((4, 4, 2), np.uint8), (2, 2)),
    (np.zeros((4,), np.uint8), (2, 2)), (np.zeros((4, 4), np.uint8), (0, 2)),
    (np.zeros((0, 4), np.uint8), (2, 2))])
def test_bad_images_raise(img, size):
    with pytest.raises(ValueError):
        resize(img, size, "bilinear")


def write_committed_fixtures(out_dir):
    """Write ``tests/torch_fixtures/resample/pillow_resize.npz``: for each
    mode and (size, target) of :data:`SIZES`, the input image
    (``in__<case>``) and Pillow's resize of it with each filter
    (``out__<case>__<filter>``); returns {key: array}."""
    arrays = {}
    for channels in sorted(MODES):
        for src, dst in SIZES:
            name = case_name(channels, src, dst)
            img = sample_image(*src, channels, seed=src[0] * 7 + src[1])
            arrays[f"in__{name}"] = img
            for flt in sorted(PIL_FILTERS):
                arrays[f"out__{name}__{flt}"] = pillow(img, dst, flt)
    os.makedirs(out_dir, exist_ok=True)
    # np.savez_compressed's layout at zlib's highest level
    with zipfile.ZipFile(os.path.join(out_dir, "pillow_resize.npz"), "w",
                         zipfile.ZIP_DEFLATED, compresslevel=9) as zf:
        for key, arr in arrays.items():
            with zf.open(key + ".npy", "w") as f:
                np.lib.format.write_array(f, arr)
    return arrays


def test_committed_fixtures_against_the_port():
    n, worst = CS.check_resample_fixtures()
    assert n == len(MODES) * len(SIZES) * len(PIL_FILTERS) and worst == 0
    assert os.path.getsize(CS.RESAMPLE_FIXTURES) < 200_000


def test_the_generator_wrote_the_committed_fixtures(tmp_path):
    got = write_committed_fixtures(str(tmp_path))
    with np.load(CS.RESAMPLE_FIXTURES) as z:
        want = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# -- the loaders, against JAX's on the same files

@pytest.mark.parametrize("kind", ["rgb.png", "rgba.png", "grey.png", "rgb.jpg"])
def test_image_ref_resizes_as_jax(tmp_path, kind):
    """A frame of another size, up and down: LANCZOS after the decode and
    ``convert("RGB")``. PNG is exact against JAX's ref; JPEG too, since the
    decoder equals Pillow's on this file (checked first)."""
    channels = {"rgb": 3, "rgba": 4, "grey": 1}[kind.split(".")[0]]
    img = sample_image(41, 27, channels, seed=9)
    path = str(tmp_path / kind)
    if kind.endswith(".png"):
        png.write_png(path, img)
    else:
        Image.fromarray(img).save(path, quality=90)
        from fourdgs_tpu_torch.utils import jpeg
        np.testing.assert_array_equal(jpeg.read_jpeg(path), np.asarray(Image.open(path)))
    for size in ((20, 13), (64, 43)):
        got = ImageRef(path, size)()
        assert got.shape == (size[1], size[0], 3)
        np.testing.assert_array_equal(got, JImageRef(path, size)())


def test_blender_frames_resize_as_jax(tmp_path):
    """RGBA frames of another size, one with partial alpha: both loaders
    resize them (BICUBIC, premultiplied) before the composite, on white and
    on black."""
    from tests.test_data import make_dnerf_dataset

    make_dnerf_dataset(tmp_path, n_train=2, n_test=1, size=24)
    Image.fromarray(sample_image(24, 24, 4, seed=5), "RGBA").save(tmp_path / "train" / "r_0.png")
    mapper, _ = jblender.read_timeline(str(tmp_path))
    for white in (True, False):
        args = (str(tmp_path), "transforms_train.json", white, ".png", mapper)
        got = tblender.read_cameras_from_transforms(*args, target_size=(37, 29))
        want = jblender.read_cameras_from_transforms(*args, target_size=(37, 29))
        for g, w in zip(got, want):
            assert g.image.shape == (29, 37, 3)
            np.testing.assert_array_equal(g.image, w.image)
            assert (g.camera.width, g.camera.height) == (w.camera.width, w.camera.height)


def test_covisible_mask_resizes_as_jax(tmp_path):
    """``read_mask`` of a mask of another size equals JAX's
    ``Image.open(p).convert("L").resize((w, h), BILINEAR)`` (train.py and
    render.py), from an L and an RGB file."""
    m = (np.random.default_rng(2).random((30, 40)) > 0.5).astype(np.uint8) * 255
    for name, img in (("l.png", m), ("rgb.png", np.repeat(m[:, :, None], 3, 2))):
        path = str(tmp_path / name)
        Image.fromarray(img).save(path)
        for w, h in ((32, 24), (40, 30), (57, 41)):
            want = np.asarray(Image.open(path).convert("L").resize((w, h), Image.BILINEAR))
            np.testing.assert_array_equal(read_mask(path, w, h), want)


def test_build_flags_and_links_nothing():
    lib = native.build(resample.SRC, resample.FLAGS)
    assert lib == native.lib_path(resample.SRC, resample.FLAGS)
    assert lib != native.lib_path(resample.SRC)   # the flags are in the key
    assert "-ffp-contract=off" in resample.FLAGS
    assert not any(f.startswith("-l") for f in resample.FLAGS + native.CXX_FLAGS)
    assert resample.get_lib()._name == str(lib)
