"""The image fixtures of the port's numpy decoders, made with PIL.

    python tests/make_torch_image_fixtures.py

writes one file of each case `tests/test_torch_jpeg.py` holds the decoders
to (`CASES`: JPEG subsamplings, gray, a restart interval, sizes that are not
a multiple of the MCU, quality 50 and 95, optimized Huffman tables, Adobe
RGB, a chroma plane 2 samples wide; 24-, 8- and 32-bit BMPs, top-down rows,
BI_BITFIELDS) and a 512-px photo-like 4:2:0 JPEG under
``tests/fixtures/torch_images/``, and PIL's decode of each (``convert("RGB")``)
into ``goldens.npz``, each array differenced along its rows mod 256 so that
deflate packs it (`golden` undoes that). `chip_smoke.py` decodes them on
the card's machine, which has no PIL; `tests/test_torch_jpeg.py` checks
that they still equal live PIL.
"""

from __future__ import annotations

import io
import os
import struct

import numpy as np

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "torch_images")
GOLDENS = os.path.join(FIXTURES, "goldens.npz")


def smooth(size, seed, mode="RGB"):
    """A smooth image: 16x16 noise resized bicubically to ``size`` (w, h)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    shape = (16, 16, 3) if mode == "RGB" else (16, 16)
    return Image.fromarray(rng.integers(0, 256, shape, np.uint8), mode).resize(size,
                                                                               Image.BICUBIC)


def photo(n: int, seed: int):
    """A photo-like n x n image: a smooth background, blurred discs with
    sharp-ish edges."""
    from PIL import Image, ImageDraw, ImageFilter

    rng = np.random.default_rng(seed)
    img = Image.fromarray(rng.integers(0, 256, (6, 6, 3), np.uint8)).resize((n, n),
                                                                           Image.BICUBIC)
    draw = ImageDraw.Draw(img)
    for _ in range(12):
        x0, y0 = rng.integers(0, n, 2)
        r = rng.integers(n // 16, n // 5)
        draw.ellipse([x0 - r, y0 - r, x0 + r, y0 + r],
                     fill=tuple(int(v) for v in rng.integers(0, 256, 3)))
    return img.filter(ImageFilter.GaussianBlur(1.5))


def bmp32(px: np.ndarray, top_down: bool, masks=None) -> bytes:
    """(H, W, 3) uint8 as a 32-bit BMP: BI_RGB (BGRX, X = 77) or
    BI_BITFIELDS with ``masks`` (R, G, B); rows bottom-up unless
    ``top_down``."""
    h, w, _ = px.shape
    if masks is None:
        raw = np.concatenate([px[..., ::-1], np.full((h, w, 1), 77, np.uint8)], 2)
    else:
        v = np.zeros((h, w), np.uint32)
        for c, m in enumerate(masks):
            v |= px[..., c].astype(np.uint32) << ((m & -m).bit_length() - 1)
        raw = v.astype("<u4").view(np.uint8).reshape(h, w, 4)
    body = (raw if top_down else raw[::-1]).tobytes()
    extra = struct.pack("<III", *masks) if masks else b""
    head = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, 32, 3 if masks else 0,
                       len(body), 2835, 2835, 0, 0)
    off = 14 + 40 + len(extra)
    return b"BM" + struct.pack("<IHHI", off + len(body), 0, 0, off) + head + extra + body


def bmp24_top_down(px: np.ndarray) -> bytes:
    h, w, _ = px.shape
    stride = (3 * w + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :3 * w] = px[..., ::-1].reshape(h, 3 * w)
    head = struct.pack("<IiiHHIIiiII", 40, w, -h, 1, 24, 0, rows.size, 2835, 2835, 0, 0)
    return b"BM" + struct.pack("<IHHI", 54 + rows.size, 0, 0, 54) + head + rows.tobytes()


def _save(img, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


def _px(seed: int, h: int = 13, w: int = 23) -> np.ndarray:
    return np.asarray(smooth((w, h), seed))


# name -> bytes of the case, made with PIL (or by hand where PIL writes no such file)
CASES = {
    "j444.jpg": lambda: _save(smooth((48, 40), 1), "JPEG", quality=75, subsampling=0),
    "j422.jpg": lambda: _save(smooth((48, 40), 1), "JPEG", quality=75, subsampling=1),
    "j420.jpg": lambda: _save(smooth((48, 40), 1), "JPEG", quality=75, subsampling=2),
    "jgray.jpg": lambda: _save(smooth((45, 31), 2, "L"), "JPEG", quality=75),
    "jrestart.jpg": lambda: _save(smooth((70, 52), 3), "JPEG", quality=80, subsampling=2,
                                  restart_marker_blocks=2),
    "jodd420.jpg": lambda: _save(smooth((61, 37), 4), "JPEG", quality=75, subsampling=2),
    "jodd422.jpg": lambda: _save(smooth((61, 37), 4), "JPEG", quality=75, subsampling=1),
    "jq50.jpg": lambda: _save(smooth((40, 30), 5), "JPEG", quality=50, subsampling=2),
    "jq95.jpg": lambda: _save(smooth((40, 30), 5), "JPEG", quality=95, subsampling=2),
    "joptimize.jpg": lambda: _save(smooth((40, 30), 6), "JPEG", quality=90, optimize=True),
    "jadobe_rgb.jpg": lambda: _save(smooth((33, 20), 7), "JPEG", quality=85, keep_rgb=True),
    "jnarrow.jpg": lambda: _save(smooth((3, 5), 8), "JPEG", quality=90, subsampling=2),
    "b24.bmp": lambda: _save(smooth((23, 13), 9), "BMP"),
    "b8_palette.bmp": lambda: _save(smooth((23, 13), 10).convert("P", palette=1, colors=50),
                                    "BMP"),
    "b8_gray.bmp": lambda: _save(smooth((23, 13), 11, "L"), "BMP"),
    "b32.bmp": lambda: _save(smooth((23, 13), 12).convert("RGBA"), "BMP"),
    "b24_top_down.bmp": lambda: bmp24_top_down(_px(13)),
    "b32_top_down.bmp": lambda: bmp32(_px(14), True),
    "b32_bitfields.bmp": lambda: bmp32(_px(15), False, (0xFF0000, 0xFF00, 0xFF)),
    "photo512.jpg": lambda: _save(photo(512, 0), "JPEG", quality=85, subsampling=2),
}


def pil_rgb(data: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def golden(stored: np.ndarray) -> np.ndarray:
    """A golden as ``goldens.npz`` stores it (differenced along its rows, mod
    256) -> the (H, W, 3) uint8 array."""
    return np.cumsum(stored, axis=1, dtype=np.uint8)


def main() -> None:
    os.makedirs(FIXTURES, exist_ok=True)
    stored = {}
    for name, make in CASES.items():
        data = make()
        with open(os.path.join(FIXTURES, name), "wb") as f:
            f.write(data)
        rgb = pil_rgb(data)
        stored[name] = np.diff(rgb, axis=1, prepend=np.uint8(0)).astype(np.uint8)
        assert np.array_equal(golden(stored[name]), rgb)
    np.savez_compressed(GOLDENS, **stored)
    total = sum(os.path.getsize(os.path.join(FIXTURES, f)) for f in os.listdir(FIXTURES))
    print(f"{len(CASES)} fixtures and their goldens: {total} bytes in {FIXTURES}")


if __name__ == "__main__":
    main()
