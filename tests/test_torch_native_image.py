"""The port's native image decoder (flocoder_torch.data.native_image over its
own csrc/fcimage.cpp) against the JAX package's (flocoder_tpu.data.
native_image) and PIL.

For PNG, JPEG, grayscale and RGBA files and three resample sizes (a
shrink, an enlargement of a 40-px square and of a 128×96 image), the port's
library gives the same bytes as the JAX package's, and stays within 2
levels of PIL's BILINEAR resize (the bound of tests/test_native_image.py:
PIL quantizes its filter coefficients to 8 bits). The batch API equals the
single-file calls and flags a missing and a corrupt file;
``NativeLoadResized`` takes a path, a PIL image and a webp file (which the
native decoder rejects, so PIL decodes it), and ``ImageFolderDataset``
hands it paths and redraws a file that fails. The library is built under ``flocoder_torch/build/``.
"""
import os

import numpy as np
import pytest
from PIL import Image

from flocoder_torch.data import native_image as tn
from flocoder_torch.data.datasets import ImageFolderDataset
from flocoder_torch.ops.kernels.build import BUILD_DIR
from flocoder_tpu.data import native_image as jn

pytestmark = pytest.mark.skipif(not tn.available(),
                                reason="libjpeg/libpng headers missing: the native "
                                       "decoder does not build")


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    sq = rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)
    big = rng.integers(0, 256, (128, 96, 3), dtype=np.uint8)
    gray = rng.integers(0, 256, (40, 40), dtype=np.uint8)
    rgba = np.dstack([sq, rng.integers(0, 256, (40, 40), dtype=np.uint8)])
    Image.fromarray(sq).save(d / "sq.png")
    Image.fromarray(big).save(d / "big.png")
    Image.fromarray(big).save(d / "big.jpg", quality=95)
    Image.fromarray(gray, "L").save(d / "gray.png")
    Image.fromarray(rgba, "RGBA").save(d / "rgba.png")
    Image.fromarray(sq).save(d / "sq.webp", lossless=True)
    (d / "bad.png").write_bytes(b"\x89PNG\r\n\x1a\n not a png")
    return d


@pytest.mark.parametrize("name", ["sq.png", "big.png", "big.jpg", "gray.png", "rgba.png"])
@pytest.mark.parametrize("size", [24, 48, 160])
def test_bytes_equal_the_jax_decoder_and_near_pil(images, name, size):
    path = str(images / name)
    ours = tn.decode_resize(path, size)
    assert ours.shape == (size, size, 3) and ours.dtype == np.uint8
    assert ours.tobytes() == jn.decode_resize(path, size).tobytes()
    pil = np.asarray(Image.open(path).convert("RGB").resize((size, size), Image.BILINEAR))
    assert np.abs(ours.astype(np.int16) - pil.astype(np.int16)).max() <= 2


def test_decode_without_resize_is_exact(images):
    sq = np.asarray(Image.open(images / "sq.png"))
    np.testing.assert_array_equal(tn.decode_resize(str(images / "sq.png"), 40), sq)
    rgba = np.asarray(Image.open(images / "rgba.png"))
    np.testing.assert_array_equal(tn.decode_resize(str(images / "rgba.png"), 40),
                                  rgba[..., :3])        # alpha dropped, as convert("RGB")


def test_batch_api_matches_single_calls_and_flags_bad_files(images):
    good = [str(images / n) for n in ("sq.png", "big.png", "big.jpg", "gray.png")]
    paths = good + [str(images / "missing.png"), str(images / "bad.png"),
                    str(images / "sq.webp")]
    out, ok = tn.decode_resize_batch(paths, 48, n_threads=4)
    assert ok.tolist() == [True] * 4 + [False] * 3
    for i, p in enumerate(good):
        np.testing.assert_array_equal(out[i], tn.decode_resize(p, 48))
    assert tn.decode_resize(str(images / "bad.png"), 48) is None


def test_native_load_resized_takes_a_path_a_pil_image_and_a_webp(images):
    from flocoder_torch.data.device_augs import load_resized
    tf = tn.NativeLoadResized(32)
    assert tf.wants_path
    arr = tf(str(images / "sq.png"))
    assert arr.shape == (32, 32, 3) and arr.dtype == np.float32
    np.testing.assert_array_equal(
        arr, tn.decode_resize(str(images / "sq.png"), 32).astype(np.float32) / 255.0)
    img = Image.open(images / "sq.png").convert("RGB")
    np.testing.assert_array_equal(tf(img), load_resized(img, 32))
    webp = tf(str(images / "sq.webp"))                    # the native decoder rejects webp
    np.testing.assert_array_equal(webp, load_resized(Image.open(images / "sq.webp"), 32))

    ds = ImageFolderDataset(str(images), transform=tf)
    x, label = ds.get(ds.files.index(str(images / "sq.png")), np.random.default_rng(0))
    np.testing.assert_array_equal(x, arr)
    assert not ds._cache                                  # paths are never decoded by PIL here
    bad, _ = ds.get(ds.files.index(str(images / "bad.png")), np.random.default_rng(1))
    assert bad.shape == (32, 32, 3)                       # a file that fails is redrawn


def test_library_is_built_under_the_ports_build_dir():
    path = os.path.realpath(tn.library_file())
    assert path.startswith(os.path.realpath(BUILD_DIR) + os.sep)
    assert os.path.basename(path).startswith("libfcimage_")
    assert tn.why_unavailable() == ""
