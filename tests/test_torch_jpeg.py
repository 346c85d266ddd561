"""The port's numpy decoders of baseline JPEG and BMP against PIL (CPU).

Bounds: every JPEG case decodes to PIL's pixels exactly (the issue's bound
was 3 LSB max, 0.5 mean; the decoder does libjpeg's integer IDCT, fancy
upsampling and colour tables, so it reaches PIL's bits); BMPs exactly;
decode + Lanczos-3 within the 3 LSB that the PNG path keeps against PIL's
resize, here against the JAX dataset at ``use_native=False`` (PIL). The
committed fixtures of `chip_smoke.py` (`tests/make_torch_image_fixtures.py`)
must still equal live PIL.
"""

import io
import os

import numpy as np
import pytest
from PIL import Image

from make_torch_image_fixtures import CASES, FIXTURES, GOLDENS, golden, pil_rgb, smooth
from pcm_tpu.data import dataset as jdataset
from pcm_tpu_torch.data import dataset, jpeg, native_image

JPEG_CASES = [n for n in CASES if n.endswith(".jpg")]
BMP_CASES = [n for n in CASES if n.endswith(".bmp")]


@pytest.mark.parametrize("name", JPEG_CASES)
def test_jpeg_matches_pil(name):
    """4:4:4, 4:2:2, 4:2:0, gray, a restart interval, sizes that are not a
    multiple of the MCU, quality 50 and 95, optimized Huffman tables, Adobe
    RGB and a chroma plane 2 samples wide: PIL's pixels, bit for bit."""
    data = CASES[name]()
    ours = jpeg.decode_jpeg(data)
    np.testing.assert_array_equal(ours, pil_rgb(data))
    np.testing.assert_array_equal(native_image.decode_image(data), ours)


@pytest.mark.parametrize("name", BMP_CASES)
def test_bmp_matches_pil(name):
    """24-bit, 8-bit palette and gray, 32-bit BI_RGB, top-down rows and
    BI_BITFIELDS: PIL's pixels exactly."""
    data = CASES[name]()
    np.testing.assert_array_equal(native_image.decode_bmp(data), pil_rgb(data))


def test_committed_fixtures_equal_live_pil():
    """The smoke's fixtures are the cases as `CASES` makes them, their goldens
    are live PIL's decode, and the numpy decoders give the goldens."""
    stored = np.load(GOLDENS)
    assert set(stored.files) == set(CASES)
    for name, make in CASES.items():
        with open(os.path.join(FIXTURES, name), "rb") as f:
            data = f.read()
        ref = pil_rgb(data)
        np.testing.assert_array_equal(golden(stored[name]), ref, err_msg=name)
        np.testing.assert_array_equal(native_image.load_rgb(os.path.join(FIXTURES, name)), ref,
                                      err_msg=name)
        if name.endswith(".bmp"):  # PIL writes BMPs bit for bit again
            assert make() == data, name


@pytest.mark.parametrize("mode,progressive,why", [
    ("RGB", True, "progressive"), ("CMYK", False, "four-component")],
    ids=["progressive", "cmyk"])
def test_unsupported_jpegs_are_refused_by_name(tmp_path, mode, progressive, why):
    data = io.BytesIO()
    smooth((24, 16), 1).convert(mode).save(data, "JPEG", progressive=progressive)
    with pytest.raises(ValueError, match=why):
        jpeg.decode_jpeg(data.getvalue())
    path = tmp_path / "x.jpg"
    path.write_bytes(data.getvalue())
    with open(path, "rb") as f:
        assert why in jpeg.frame_problem(f)
    assert why in native_image.numpy_problem(str(path))


@pytest.mark.parametrize("marker,why", [(0xC9, "arithmetic-coded"), (0xC3, "lossless")])
def test_other_frames_and_precisions_are_refused(marker, why):
    """A frame marker of another process, and a 12-bit precision, by name."""
    data = bytearray(CASES["j420.jpg"]())
    sof = data.find(b"\xff\xc0")
    data[sof + 1] = marker
    with pytest.raises(ValueError, match=why):
        jpeg.decode_jpeg(bytes(data))
    data[sof + 1] = 0xC0
    data[sof + 4] = 12  # P, the sample precision
    with pytest.raises(ValueError, match="12-bit"):
        jpeg.decode_jpeg(bytes(data))


def test_rle_bmp_is_refused_by_name():
    import struct

    head = (b"BM" + struct.pack("<IHHI", 1078, 0, 0, 1078)
            + struct.pack("<IiiHHIIiiII", 40, 4, 4, 1, 8, 1, 0, 0, 0, 0, 0) + bytes(1024))
    with pytest.raises(ValueError, match="RLE8"):
        native_image.decode_bmp(head)


def test_h1v2_upsampling_is_h2v1_transposed():
    """libjpeg's h1v2 fancy upsampling has h2v1's taps and biases along the
    other axis (PIL writes no 4:4:0 file to hold it to)."""
    x = np.random.default_rng(0).integers(0, 256, (5, 7), np.uint8)
    np.testing.assert_array_equal(jpeg.upsample(x, 2, 1), jpeg.upsample(x.T, 1, 2).T)


@pytest.mark.parametrize("size,res", [((640, 480), 128), ((40, 64), 64)], ids=["down", "up"])
def test_decode_and_lanczos_match_the_jax_dataset(tmp_path, size, res):
    """JPEGs of each subsampling, gray and quality 95, a BMP and a PNG, of
    the smooth images `tests/test_native_image.py` holds the native pipeline
    to, through `load_resized_numpy`: equal to the same Lanczos on PIL's
    decode (the decoders add nothing), and against the JAX dataset's PIL
    path (``use_native=False``) within 1 LSB mean. Shrinking (the training
    case), within the PNG path's 3 LSB max too. Enlarging, the float
    Lanczos, which rounds once where PIL rounds between its passes, is up to
    5 LSB from PIL on these JPEGs' blocky detail (2 on the PNG and BMP: the
    resize's difference, not the decoder's; the PNG path notes the same in
    `tests/test_torch_pixels.py::test_numpy_decoder_matches_pil`), so there
    the max is held on the lossless files alone."""
    img = smooth(size, 0)
    for name, kw in (("a444.jpg", {"subsampling": 0}), ("a422.jpg", {"subsampling": 1}),
                     ("a420.jpg", {"subsampling": 2}), ("q95.jpg", {"quality": 95}),
                     ("b.bmp", {}), ("c.png", {})):
        img.save(tmp_path / name, **kw)
    img.convert("L").save(tmp_path / "gray.jpg")
    ref = jdataset.ImageFolderDataset(str(tmp_path), resolution=res, use_native=False)
    ours = dataset.ImageFolderDataset(str(tmp_path), resolution=res, use_native=False)
    assert ours.files == ref.files and len(ours) == 7
    for path in ours.files:
        a = native_image.load_resized_numpy(path, res)
        with open(path, "rb") as f:
            np.testing.assert_array_equal(a, native_image.resize_shortest(pil_rgb(f.read()), res))
        b = ref._load_resized_rgb(path)
        assert a.shape == b.shape and min(a.shape[:2]) == res
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert d.mean() < 1.0, path
        if res < min(size) or not path.endswith(".jpg"):
            assert d.max() <= 3, (path, d.max())


def test_resize_to_matches_pil():
    """`resize_to` to an exact size (the eval CLIs' square resize) against
    PIL's ``resize((w, h), LANCZOS)``: within 3 LSB max, 1 LSB mean."""
    img = smooth((70, 45), 3)
    for w, h in ((32, 32), (299, 299), (50, 20)):
        ref = np.asarray(img.resize((w, h), Image.LANCZOS))
        ours = native_image.resize_to(np.asarray(img), h, w)
        d = np.abs(ours.astype(np.int32) - ref.astype(np.int32))
        assert ours.shape == (h, w, 3) and d.max() <= 3 and d.mean() < 1.0, (w, h)
