"""Image decode + shortest-side Lanczos-3 resize for the image loader
(counterpart of `pcm_tpu/data/native_image.py`).

Two decoders, one contract: ``load_resized(path, res)`` returns an (H, W, 3)
uint8 RGB array whose shortest side is ``res`` (the longer one
``max(res, round(side * res / shortest))``), unchanged when already there.

- ``native``: the port's own ctypes binding of ``native/image_pipe.cpp``
  (JPEG/PNG/WebP, the C call releases the GIL), built at first use with
  ``g++`` into ``build/pcm_tpu_torch/native/<source hash>/libimage_pipe.so``
  (`native_library`), which needs the libjpeg, libpng and libwebp headers.
  The build runs under a lock file shared by every process and writes a
  temporary name that it renames, so no process loads a half-written
  library.
- ``numpy``: decoders told apart by magic bytes (`decode_image`): 8-bit
  PNGs (gray, gray+alpha, RGB, RGBA, palette; not interlaced) on the
  standard library's ``zlib``, whose Average and Paeth rows, sequential
  along a row, are undone a diagonal of the image at a time (`_wavefront`);
  baseline JPEGs (`data/jpeg.py`, libjpeg's IDCT, upsampling and colour
  conversion, so PIL's pixels); uncompressed BMPs (8-bit palette, 24- and
  32-bit); and a separable Lanczos-3 resize with PIL's convention (support
  3 x scale, centers at (i + 0.5) x scale, normalized taps, float
  accumulation, one rounding), as two float32 matrix products, to the
  shortest side (`resize_shortest`) or an exact size (`resize_to`).
  `numpy_problem` names what they refuse (WebP, progressive and other
  non-baseline JPEGs, compressed BMPs) from a file's first bytes. Where the
  native library does not build, every image takes this path. BMPs take it
  always, and so do PNGs with an alpha channel: the native library
  composites them onto black (libpng's simplified API), where PIL's
  ``convert("RGB")``, the reference's loader, drops the alpha.

`available()` says whether the native one loads here, `native_error()` why not.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import struct
import subprocess
import threading
import zlib
from typing import Optional

import numpy as np

from . import jpeg

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(_REPO, "native")
BUILD_DIR = os.path.join(_REPO, "build", "pcm_tpu_torch", "native")
# the flags of `native/Makefile`'s libimage_pipe.so
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")
LIBS = ("-ljpeg", "-lpng", "-lwebp")
NATIVE_EXTS = (".jpg", ".jpeg", ".png", ".webp")
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"

_lock = threading.Lock()
_lib = None
_load_error: Optional[str] = None


def native_library(source: str = "image_pipe.cpp", libs=LIBS) -> str:
    """The path of the library ``lib<stem>.so`` built from the checkout's
    ``native/<source>``: a directory a source and flags hash, so an edit
    builds anew."""
    with open(os.path.join(NATIVE_DIR, source), "rb") as f:
        h = hashlib.sha256(" ".join(CXX_FLAGS + tuple(libs)).encode())
        h.update(f.read())
    return os.path.join(BUILD_DIR, h.hexdigest()[:16],
                        f"lib{os.path.splitext(source)[0]}.so")


@contextlib.contextmanager
def _build_lock(path: str):
    """An exclusive lock on ``<dir of path>/lock``, across processes."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(os.path.join(os.path.dirname(path), "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def build_native(path: str, source: str = "image_pipe.cpp", libs=LIBS) -> None:
    """Compile ``native/<source>`` to ``path`` unless it exists: ``g++`` to a
    temporary name, then a rename, under the lock."""
    with _build_lock(path):
        if os.path.exists(path):
            return
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, os.path.join(NATIVE_DIR, source),
                            *libs], check=True, capture_output=True, text=True)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)


def load_native(source: str, libs=LIBS) -> ctypes.CDLL:
    """``native/<source>`` built (`build_native`, once for every process)
    and loaded; a load that fails is tried once more under the build lock,
    with no build of another process under way."""
    path = native_library(source, libs)
    build_native(path, source, libs)
    try:
        return ctypes.CDLL(path)
    except OSError:
        with _build_lock(path):
            return ctypes.CDLL(path)


def _load(path: str) -> ctypes.CDLL:
    return _bind(ctypes.CDLL(path))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.ip_load_resized.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.ip_load_resized.restype = ctypes.c_int
    lib.ip_free.argtypes = [ctypes.POINTER(ctypes.c_ubyte)]
    lib.ip_free.restype = None
    return lib


def _get_lib():
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    with _lock:
        if _lib is not None or _load_error is not None:
            return _lib
        try:
            _lib = _bind(load_native("image_pipe.cpp"))
        except subprocess.CalledProcessError as e:
            _load_error = f"g++ libimage_pipe.so failed: {(e.stderr or '').strip()[-300:]}"
        except OSError as e:
            _load_error = f"libimage_pipe.so did not build or load: {e}"
    return _lib


def available() -> bool:
    """Whether the native library is built (building it on first call) and loads."""
    return _get_lib() is not None


def native_error() -> Optional[str]:
    """Why the native library is unavailable (None when it loads)."""
    _get_lib()
    return _load_error


def load_resized_native(path: str, res: int) -> np.ndarray:
    lib = _get_lib()
    if lib is None:
        raise RuntimeError(f"native image pipeline unavailable: {_load_error}")
    buf = ctypes.POINTER(ctypes.c_ubyte)()
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.ip_load_resized(path.encode(), int(res), ctypes.byref(buf), ctypes.byref(w),
                             ctypes.byref(h))
    if rc != 0:
        raise ValueError(f"ip_load_resized({path!r}) failed rc={rc}")
    try:
        n = h.value * w.value * 3
        return np.ctypeslib.as_array(buf, shape=(n,)).reshape(h.value, w.value, 3).copy()
    finally:
        lib.ip_free(buf)


# -- numpy PNG decoder --------------------------------------------------------

_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel


_BAND_ELEMS = 1 << 23  # skewed int16 elements a band of the wavefront holds


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the five PNG row filters; (h, stride) uint8. Rows filtered with
    None, Sub or Up are undone a row at a time; a band of rows that holds an
    Average or Paeth row (sequential along the row) goes through
    `_wavefront`, bands bounded to ``_BAND_ELEMS``."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {rows.size} bytes, not {h} rows of {stride + 1}")
    rows = rows.reshape(h, stride + 1)
    kinds, data = rows[:, 0], rows[:, 1:]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"PNG filter type {kinds.max()}")
    w = stride // bpp
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    band = max(1, min(h, _BAND_ELEMS // ((w + 1) * bpp)))
    for r0 in range(0, h, band):
        r1 = min(h, r0 + band)
        if (kinds[r0:r1] >= 3).any():
            out[r0:r1] = _wavefront(data[r0:r1].reshape(r1 - r0, w, bpp), kinds[r0:r1],
                                    prior.reshape(w, bpp)).reshape(r1 - r0, stride)
        else:
            for y in range(r0, r1):
                line = data[y]
                if kinds[y] == 1:  # Sub: a running sum along the row, per byte of a pixel
                    line = np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.uint8).reshape(-1)
                elif kinds[y] == 2:  # Up
                    line = line + prior
                out[y] = line
                prior = out[y]
        prior = out[r1 - 1]
    return out


def _wavefront(data: np.ndarray, kinds: np.ndarray, prior: np.ndarray) -> np.ndarray:
    """Rows (n, w, bpp) of any filters undone over the anti-diagonals
    d = x + y: a pixel needs only its left (a), upper (b) and upper-left (c)
    neighbours, all on the two diagonals before its own, so a diagonal is
    one vector step. The rows are held skewed, t[d + 2, y + 1] = out[y, d - y],
    which makes each diagonal's neighbours slices; zeros stand left of the
    image, ``prior`` (w, bpp) for the row above."""
    n, w, bpp = data.shape
    diags = n + w - 1
    y, x = np.ogrid[:n, :w]
    raw = np.zeros((diags, n, bpp), np.int16)
    raw[y + x, y] = data
    t = np.zeros((diags + 2, n + 1, bpp), np.int16)
    t[1:w + 1, 0] = prior
    sub, up, avg, paeth = (np.broadcast_to((kinds == k)[:, None], (n, bpp)) for k in (1, 2, 3, 4))
    for d in range(diags):
        y0, y1 = max(0, d - w + 1), min(n, d + 1)
        a, b, c = t[d + 1, y0 + 1:y1 + 1], t[d + 1, y0:y1], t[d, y0:y1]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = np.where(paeth[y0:y1],
                        np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c)),
                        np.where(avg[y0:y1], (a + b) >> 1,
                                 np.where(up[y0:y1], b, np.where(sub[y0:y1], a, 0))))
        np.bitwise_and(raw[d, y0:y1] + pred, 255, out=t[d + 2, y0 + 1:y1 + 1])
    return t[y + x + 2, y + 1].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """An 8-bit, non-interlaced PNG -> (H, W, 3) uint8 RGB (alpha dropped,
    gray repeated, palette looked up, as PIL's ``convert("RGB")``)."""
    if data[:8] != PNG_MAGIC:
        raise ValueError("not a PNG")
    pos, idat, plte, ihdr = 8, [], None, None
    while pos + 8 <= len(data):
        (n,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, colour, _, _, interlace = ihdr
    if depth != 8 or colour not in _CHANNELS or interlace:
        raise ValueError(f"PNG of bit depth {depth}, colour type {colour}, interlace "
                         f"{interlace}: the numpy decoder reads 8-bit, non-interlaced ones")
    ch = _CHANNELS[colour]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch).reshape(h, w, ch)
    if colour == 3:
        if plte is None:
            raise ValueError("palette PNG without PLTE")
        return plte[px[..., 0]]
    if ch <= 2:
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


# -- numpy Lanczos-3 resize -----------------------------------------------------

def _lanczos3(x: np.ndarray) -> np.ndarray:
    out = np.zeros_like(x)
    inside = (x > -3.0) & (x < 3.0)
    xi = x[inside]
    with np.errstate(invalid="ignore", divide="ignore"):
        pix = np.pi * xi
        v = 3.0 * np.sin(pix) * np.sin(pix / 3.0) / (pix * pix)
    out[inside] = np.where(xi == 0.0, 1.0, v)
    return out


@functools.lru_cache(maxsize=64)
def _axis_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) float32 matrix of normalized Lanczos-3 taps (PIL's
    convention); cached, as a dataset repeats its sizes (read-only)."""
    scale = in_size / out_size
    fscale = max(scale, 1.0)
    support = 3.0 * fscale
    m = np.zeros((out_size, in_size), np.float32)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        taps = _lanczos3((np.arange(lo, hi) - center + 0.5) / fscale)
        total = taps.sum()
        m[xx, lo:hi] = taps / total if total != 0.0 else 0.0
    m.setflags(write=False)
    return m


def resize_to(rgb: np.ndarray, h: int, w: int) -> np.ndarray:
    """(H, W, 3) uint8 -> (h, w, 3), Lanczos-3 in float32 (PIL's ``resize((w, h),
    LANCZOS)`` convention): two matrix products (rows, then columns), one
    rounding at the end."""
    ih, iw = rgb.shape[:2]
    if (ih, iw) == (h, w):
        return rgb
    x = rgb.astype(np.float32).transpose(0, 2, 1).reshape(ih * 3, iw)
    x = (x @ _axis_weights(iw, w).T).reshape(ih, 3 * w)  # (ih, 3, w)
    x = (_axis_weights(ih, h) @ x).reshape(h, 3, w).transpose(0, 2, 1)
    return np.clip(np.floor(x + 0.5), 0, 255).astype(np.uint8)


def resize_shortest(rgb: np.ndarray, res: int) -> np.ndarray:
    """(H, W, 3) uint8 -> shortest side ``res`` (`resize_to`)."""
    h, w = rgb.shape[:2]
    scale = res / min(w, h)
    return resize_to(rgb, max(res, round(h * scale)), max(res, round(w * scale)))


# -- numpy BMP decoder ----------------------------------------------------------

BMP_MAGIC = b"BM"
_BMP_COMPRESSION = {1: "RLE8", 2: "RLE4", 4: "JPEG-in-BMP", 5: "PNG-in-BMP", 6: "alpha-bitfield"}


def _bmp_header(data: bytes):
    """(pixel offset, width, height, bits, compression, header size) of a BMP."""
    if data[:2] != BMP_MAGIC or len(data) < 26:
        raise ValueError("not a BMP")
    (offset,) = struct.unpack("<I", data[10:14])
    (size,) = struct.unpack("<I", data[14:18])
    if size == 12:  # BITMAPCOREHEADER
        w, h, _, bits = struct.unpack("<HHHH", data[18:26])
        return offset, w, h, bits, 0, size
    w, h, _, bits, compression = struct.unpack("<iiHHI", data[18:34])
    return offset, w, h, bits, compression, size


def bmp_problem(data: bytes) -> Optional[str]:
    """Why a BMP (its first 34 bytes suffice) cannot be decoded here, or None."""
    try:
        _, w, h, bits, compression, _ = _bmp_header(data)
    except (ValueError, struct.error) as e:
        return f"not a BMP ({e})"
    if compression in _BMP_COMPRESSION:
        return f"a {_BMP_COMPRESSION[compression]}-compressed BMP"
    if compression not in (0, 3) or (compression == 3 and bits != 32):
        return f"a BMP of compression {compression} at {bits} bits"
    if bits not in (8, 24, 32):
        return f"a {bits}-bit BMP"
    if w <= 0 or h == 0:
        return f"a BMP of {w}x{h} pixels"
    return None


def decode_bmp(data: bytes) -> np.ndarray:
    """An uncompressed BMP (8-bit palette, 24-bit, 32-bit BI_RGB or
    BI_BITFIELDS of 8-bit fields; bottom-up or top-down rows) -> (H, W, 3)
    uint8 RGB, as PIL's ``convert("RGB")`` (a 32-bit pixel's fourth byte
    dropped)."""
    problem = bmp_problem(data)
    if problem:
        raise ValueError(f"{problem}: the numpy decoder reads 8-bit palette, 24- and 32-bit "
                         f"uncompressed BMPs")
    offset, w, h, bits, compression, size = _bmp_header(data)
    rows, stride = abs(h), (w * bits + 31) // 32 * 4
    px = np.frombuffer(data, np.uint8, rows * stride, offset).reshape(rows, stride)
    if h > 0:  # bottom-up
        px = px[::-1]
    if bits == 8:
        (used,) = struct.unpack("<I", data[46:50]) if size >= 40 else (0,)
        entry = 3 if size == 12 else 4
        n = used or 256
        pal = np.frombuffer(data, np.uint8, n * entry, 14 + size).reshape(n, entry)[:, 2::-1]
        return pal[px[:, :w]]
    if bits == 24:
        return np.ascontiguousarray(px[:, :3 * w].reshape(rows, w, 3)[..., ::-1])
    v = px[:, :4 * w].copy().view("<u4").reshape(rows, w)
    if compression == 0:
        masks = (0xFF0000, 0xFF00, 0xFF)
    else:
        masks = struct.unpack("<III", data[54:66])  # after a 40-byte header, or in V4/V5
    out = np.empty((rows, w, 3), np.uint8)
    for c, mask in enumerate(masks):
        shift = (mask & -mask).bit_length() - 1
        if mask == 0 or mask >> shift != 0xFF:
            raise ValueError(f"a BMP with channel mask {mask:#x}: the numpy decoder reads "
                             f"8-bit fields")
        out[..., c] = (v & mask) >> shift
    return out


# -- dispatch -------------------------------------------------------------------

def _kind(head: bytes) -> str:
    if head[:8] == PNG_MAGIC:
        return "png"
    if head[:2] == jpeg.JPEG_MAGIC:
        return "jpeg"
    if head[:2] == BMP_MAGIC:
        return "bmp"
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        return "webp"
    return "unknown"


def numpy_problem(path: str) -> Optional[str]:
    """Why the numpy decoders cannot read ``path``, from its first bytes (a
    JPEG's markers up to its frame header), or None: WebP, progressive or
    other non-baseline JPEGs, compressed BMPs, unknown formats."""
    with open(path, "rb") as f:
        head = f.read(34)
        kind = _kind(head)
        if kind == "jpeg":
            f.seek(0)
            return jpeg.frame_problem(f)
    if kind == "bmp":
        return bmp_problem(head)
    if kind == "webp":
        return "a WebP image (the native image library reads WebP)"
    if kind == "unknown":
        return "not a PNG, JPEG, BMP or WebP file"
    return None


def decode_image(data: bytes) -> np.ndarray:
    """PNG, baseline JPEG or BMP bytes, told apart by their magic bytes ->
    (H, W, 3) uint8 RGB."""
    kind = _kind(data[:12])
    if kind == "png":
        return decode_png(data)
    if kind == "jpeg":
        return jpeg.decode_jpeg(data)
    if kind == "bmp":
        return decode_bmp(data)
    raise ValueError(f"{'a WebP image' if kind == 'webp' else 'an unknown format'}: the numpy "
                     f"decoder reads PNG, baseline JPEG and BMP (the native image library "
                     f"reads WebP)")


def load_rgb(path: str) -> np.ndarray:
    """``path`` decoded by the numpy decoders: (H, W, 3) uint8 RGB."""
    with open(path, "rb") as f:
        return decode_image(f.read())


def load_resized_numpy(path: str, res: int) -> np.ndarray:
    return resize_shortest(load_rgb(path), res)


def load_resized(path: str, res: int, use_native: Optional[bool] = None) -> np.ndarray:
    """Decode ``path`` and resize its shortest side to ``res``: (H, W, 3) uint8.
    ``use_native`` None: the native library where it loads. BMPs and PNGs
    with an alpha channel take the numpy decoders always."""
    if use_native is None:
        use_native = available()
    if use_native and path.lower().endswith(NATIVE_EXTS) and not _png_with_alpha(path):
        return load_resized_native(path, res)
    return load_resized_numpy(path, res)


def _png_with_alpha(path: str) -> bool:
    """A PNG of colour type 4 (gray + alpha) or 6 (RGBA), read from its IHDR."""
    with open(path, "rb") as f:
        head = f.read(26)
    return head[:8] == PNG_MAGIC and len(head) == 26 and head[25] in (4, 6)
