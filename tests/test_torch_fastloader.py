"""The port's native PNG prefetcher (``data/fastloader.py`` over its copy of
``native/fastloader.cpp``), built here with ``g++``, against the port's
``utils/png.py`` and JAX's native decoder, bit for bit: RGB and RGBA frames
under every filter type. A frame the decoder rejects (gray, another size)
goes to the ref's own decoder and is counted; one the ref cannot read
either raises. A source that does not compile raises with the compiler's
output: nothing falls back to a synchronous or Pillow path."""

import numpy as np
import pytest

from fourdgs_tpu.data import fastloader as jfast
from fourdgs_tpu_torch.data import fastloader as tfast
from fourdgs_tpu_torch.data.dynerf import ImageRef
from fourdgs_tpu_torch.utils import native, png
from fourdgs_tpu_torch.utils.resample import resize

W, H = 53, 37


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """(path, RGB pixels) of RGB and RGBA frames, each filter type."""
    d = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(0)
    out = []
    for ft in range(5):
        for ch in (3, 4):
            img = rng.integers(0, 256, (H, W, ch), dtype=np.uint8)
            path = str(d / f"f{ft}_{ch}.png")
            png.write_png(path, img, filter_type=ft)
            out.append((path, img[:, :, :3]))
    return out


def test_build_is_keyed_and_reused():
    lib = native.build(tfast.SRC, tfast.LINK_FLAGS)
    assert lib.exists() and lib.parent == native.BUILD_DIR
    assert lib.name.startswith("libfastloader-")
    assert lib == native.lib_path(tfast.SRC, tfast.LINK_FLAGS)
    assert lib != native.lib_path(tfast.SRC)   # the flags are in the key
    assert native.build(tfast.SRC, tfast.LINK_FLAGS) == lib   # not rebuilt
    assert tfast.get_lib()._name == str(lib)


def test_pool_decodes_as_png_and_jax(frames):
    """Every frame decoded natively, bit for bit as the port's codec and
    JAX's native decoder read it."""
    pool = tfast.PrefetchPool(n_threads=4)
    pool.submit_batch([ImageRef(p, (W, H)) for p, _ in frames])
    got = pool.wait_batch()
    pool.close()
    assert pool.counts() == {"submitted": 10, "native": 10, "to_ref": 0}
    for (path, want), g in zip(frames, got):
        np.testing.assert_array_equal(g, want)
        np.testing.assert_array_equal(g, png.convert(png.read_png(path), "RGB"))
        np.testing.assert_array_equal(g, jfast.decode_png(path, W, H))


def test_prefetch_pool_decodes_natively_and_counts(frames, tmp_path):
    gray_px = np.random.default_rng(1).integers(0, 256, (H, W), dtype=np.uint8)
    gray = str(tmp_path / "gray.png")
    png.write_png(gray, gray_px)
    refs = [ImageRef(p, (W, H)) for p, _ in frames] * 2 + [ImageRef(gray, (W, H))]
    want = np.stack([w for _, w in frames] * 2 + [np.repeat(gray_px[:, :, None], 3, 2)])
    pool = tfast.PrefetchPool(n_threads=4)
    try:
        pool.submit_batch(refs[:7])
        with pytest.raises(RuntimeError, match="already pending"):
            pool.submit_batch(refs)
        got = pool.wait_batch()
        pool.submit_batch(refs[7:])
        got = np.concatenate([got, pool.wait_batch()])
        with pytest.raises(RuntimeError, match="no batch submitted"):
            pool.wait_batch()
    finally:
        pool.close()
    np.testing.assert_array_equal(got, want)
    # the gray frame (colour type 0) went to its ref's decoder, and was counted
    assert pool.counts() == {"submitted": 21, "native": 20, "to_ref": 1}


def test_a_rejected_frame_the_ref_cannot_read_raises(frames, tmp_path):
    """Another size: the native decoder rejects it and the ref resizes it
    (JAX's prefetcher sends it to its ref the same way); a missing file the
    ref cannot read raises."""
    pool = tfast.PrefetchPool(n_threads=2)
    ref = ImageRef(frames[0][0], (W + 1, H))
    pool.submit_batch([ref])
    (got,) = pool.wait_batch()
    np.testing.assert_array_equal(got, resize(png.read_png(frames[0][0]), (W + 1, H),
                                              "lanczos"))
    pool.submit_batch([ImageRef(str(tmp_path / "missing.png"), (W, H))])
    with pytest.raises(FileNotFoundError):
        pool.wait_batch()
    assert pool.counts() == {"submitted": 2, "native": 0, "to_ref": 2}
    pool.close()


def test_a_failed_build_raises(tmp_path, monkeypatch):
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="broken.cpp failed to build"):
        native.build(src, tfast.LINK_FLAGS)
    assert not list((tmp_path / "_build").glob("*.so"))
