"""A baseline-JPEG decoder in numpy, for machines without libjpeg and PIL.

Reads sequential Huffman-coded JPEGs (SOF0 and SOF1) of 8-bit samples: one
component (gray) or three (YCbCr, or RGB where an Adobe marker or the
component ids say so), sampling factors up to 2x2, restart intervals, any
DQT / DHT tables (optimized Huffman tables included), one scan or several;
APPn and COM segments are skipped. Progressive, lossless, hierarchical and
arithmetic-coded files, other sample precisions and four-component (CMYK)
files are refused by name with a ``ValueError`` (`frame_problem` finds them
from the markers before the frame header, without decoding).

It follows libjpeg's decompression defaults (PIL's), so that pixels stay
within a few LSB of PIL's:
- the integer "islow" IDCT (``jidctint.c``), vectorized over the blocks;
- "fancy" (triangle) chroma upsampling for h2v1, h1v2 and h2v2
  (``jdsample.c``), with its rounding biases, over the component's real
  samples, edges replicated, then the MCU padding cropped;
- the fixed-point YCbCr -> RGB tables of ``jdcolor.c``.

Huffman decoding is a Python loop over symbols. The entropy-coded bytes
(stuffing removed, split at the restart markers) become a list of 16-bit
windows, one a bit position, so that one list index peeks at the next 16
bits; a table of 65536 entries a Huffman table maps a peek to the code's
length and, where code and magnitude bits fit in the 16, the coefficient
itself.
"""

from __future__ import annotations

import functools
import struct
from typing import BinaryIO, Dict, List, Optional, Tuple

import numpy as np

JPEG_MAGIC = b"\xff\xd8"

# zigzag position -> natural (row-major) index in the 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

_SOF_NAMES = {0xC2: "progressive", 0xC3: "lossless", 0xC5: "differential sequential",
              0xC6: "differential progressive", 0xC7: "differential lossless",
              0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded progressive",
              0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded differential",
              0xCE: "arithmetic-coded differential progressive",
              0xCF: "arithmetic-coded differential lossless"}


def _frame_problem(marker: int, body: bytes) -> Optional[str]:
    """Why a frame header (SOFn marker and body) cannot be decoded here, or None."""
    if marker in _SOF_NAMES:
        return f"a {_SOF_NAMES[marker]} JPEG (SOF{marker - 0xC0})"
    precision, _, _, ncomp = struct.unpack(">BHHB", body[:6])
    if precision != 8:
        return f"a {precision}-bit JPEG"
    if ncomp == 4:
        return "a four-component (CMYK / Adobe) JPEG"
    if ncomp not in (1, 3):
        return f"a JPEG of {ncomp} components"
    for i in range(ncomp):
        hv = body[7 + 3 * i]
        if not (1 <= hv >> 4 <= 2 and 1 <= hv & 15 <= 2):
            return f"a JPEG with sampling factors {hv >> 4}x{hv & 15}"
    return None


def _segments(read):
    """(marker, body) of each marker segment from ``read(n)``'s position up to
    and with the next SOS or EOI (EOI's body empty); fill bytes skipped."""
    while True:
        b = read(1)
        if b != b"\xff":
            raise ValueError("JPEG ends before its scan" if not b
                             else f"JPEG marker expected, found byte {b.hex()}")
        while b == b"\xff":
            b = read(1)
        if not b:
            raise ValueError("JPEG ends inside a marker")
        marker = b[0]
        if marker == 0xD9:
            yield marker, b""
            return
        if 0xD0 <= marker <= 0xD8 or marker == 0x01:
            continue  # markers without a length
        head = read(2)
        if len(head) < 2:
            raise ValueError("JPEG ends inside a marker")
        (n,) = struct.unpack(">H", head)
        body = read(n - 2)
        if len(body) < n - 2:
            raise ValueError("JPEG ends inside a marker segment")
        yield marker, body
        if marker == 0xDA:
            return


def _is_frame(marker: int) -> bool:
    return 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC)


def frame_problem(f: BinaryIO) -> Optional[str]:
    """Why the JPEG in file ``f`` cannot be decoded here (progressive,
    arithmetic-coded, 12-bit, CMYK, ...), read from its markers up to the
    frame header; None when it can."""
    if f.read(2) != JPEG_MAGIC:
        return "not a JPEG (no SOI marker)"
    try:
        for marker, body in _segments(f.read):
            if _is_frame(marker):
                return _frame_problem(marker, body)
            if marker == 0xCC:
                return "an arithmetic-coded JPEG (DAC)"
    except ValueError as e:
        return str(e)
    return "a JPEG without a frame header"


# -- Huffman tables ------------------------------------------------------------

def _table_spec(body: bytes, pos: int) -> Tuple[bytes, int]:
    """One table of a DHT segment at ``pos``: (its 16 counts and its symbols,
    the position of the next table)."""
    total = sum(body[pos + 1:pos + 17])
    if pos + 17 + total > len(body):
        raise ValueError("JPEG DHT segment is truncated")
    return body[pos + 1:pos + 17 + total], pos + 17 + total


@functools.lru_cache(maxsize=32)
def _peek_tables(spec: bytes) -> Tuple[list, dict]:
    """The 16-bit peek table of the Huffman table ``spec`` (counts and
    symbols; cached, as files of one encoder repeat their tables): entry
    ``(consumed, run + 1, value)`` where the code and its magnitude bits fit
    in 16 (``consumed`` both lengths; EOB ``run + 1`` = 64, ZRL 16 with value
    0), else ``(0, 0, 0)`` and the peek's ``(code length, run, size)`` in the
    second, slow-path dict; peeks that start no code are in neither. Shared
    by the callers: read only."""
    fast = [(0, 0, 0)] * 65536
    slow = {}
    peeks = np.arange(65536, dtype=np.int64)
    code, k = 0, 16
    for length in range(1, 17):
        for sym in spec[k:k + spec[length - 1]]:
            lo, hi = code << (16 - length), (code + 1) << (16 - length)
            code += 1
            run, size = sym >> 4, sym & 15
            if length + size > 16:
                slow.update(dict.fromkeys(range(lo, hi), (length, run, size)))
            elif size == 0:  # EOB (run 0), ZRL (run 15), or a DC difference of 0
                fast[lo:hi] = [(length, 64 if run == 0 else run + 1, 0)] * (hi - lo)
            else:
                bits = (peeks[lo:hi] >> (16 - length - size)) & ((1 << size) - 1)
                vals = np.where(bits >> (size - 1), bits, bits - (1 << size) + 1).tolist()
                fast[lo:hi] = [(length + size, run + 1, v) for v in vals]
        k += spec[length - 1]
        code <<= 1
    return fast, slow


# -- entropy-coded data --------------------------------------------------------

def _scan_bits(data: bytes, start: int) -> Tuple[memoryview, List[int], int]:
    """The entropy-coded data from ``start``: (16-bit windows a bit position,
    a memoryview of uint16, which the decode loop indexes as fast as a list
    at an eighth of its memory; the bit positions where each restart
    interval's data begins; the offset of the marker that ends the scan)."""
    arr = np.frombuffer(data, np.uint8, offset=start)
    ff = np.flatnonzero(arr[:-1] == 0xFF)
    nxt = arr[ff + 1]
    ends = ff[(nxt != 0) & ((nxt < 0xD0) | (nxt > 0xD7)) & (nxt != 0xFF)]
    end = int(ends[0]) if len(ends) else len(arr)
    inside = ff < end
    ff, nxt = ff[inside], nxt[inside]
    keep = np.ones(end, bool)
    keep[ff[nxt == 0] + 1] = False  # stuffed zero bytes
    rst = ff[(nxt >= 0xD0) & (nxt <= 0xD7)]
    keep[rst] = False
    keep[rst + 1] = False
    kept = np.cumsum(keep)
    seg = (8 * kept[rst]).tolist() if len(rst) else []
    u = np.concatenate([arr[:end][keep], np.zeros(4, np.uint8)]).astype(np.uint32)
    w24 = (u[:-2] << 16) | (u[1:-1] << 8) | u[2:]
    win = np.empty((len(w24), 8), np.uint16)
    for r in range(8):
        win[:, r] = (w24 >> (8 - r)) & 0xFFFF
    return memoryview(win.reshape(-1)), seg, start + end


def _decode_scan(win, seg, slots, n_mcus: int, restart: int, dc_tabs, ac_tabs) -> np.ndarray:
    """Huffman-decode a scan: ``slots`` is the scan's component slot of each
    block of an MCU; returns the (n_mcus * len(slots), 64) coefficients in
    zigzag order, DC predictions undone."""
    coefs = np.zeros(n_mcus * len(slots) * 64 + 64, np.int32)
    out = memoryview(coefs)
    pred = [0] * 4
    p = 0
    next_seg = 0
    base = 0
    tabs = [(dc_tabs[s][0], dc_tabs[s][1], ac_tabs[s][0], ac_tabs[s][1], s) for s in slots]
    try:
        for m in range(n_mcus):
            if restart and m and m % restart == 0:
                p = seg[next_seg]
                next_seg += 1
                pred = [0] * 4
            for dcf, dcs, acf, acs, s in tabs:
                v = win[p]
                c, _, diff = dcf[v]
                if c:
                    p += c
                else:
                    length, _, size = dcs[v]
                    p += length
                    diff = 0
                    if size:
                        bits = win[p] >> (16 - size)
                        p += size
                        diff = bits if bits >> (size - 1) else bits - (1 << size) + 1
                pred[s] += diff
                out[base] = pred[s]
                k = 1
                while k < 64:
                    v = win[p]
                    c, r, val = acf[v]
                    if c:
                        p += c
                        k += r
                        if val:
                            out[base + k - 1] = val
                        continue
                    length, run, size = acs[v]
                    p += length
                    if size == 0:
                        k += 64 if run == 0 else 16
                        continue
                    bits = win[p] >> (16 - size)
                    p += size
                    k += run
                    out[base + k] = bits if bits >> (size - 1) else bits - (1 << size) + 1
                    k += 1
                base += 64
    except (KeyError, IndexError) as e:
        raise ValueError(f"corrupt JPEG entropy-coded data ({type(e).__name__})") from None
    return coefs[:base].astype(np.int64).reshape(-1, 64)


# -- IDCT (jidctint.c, CONST_BITS 13, PASS1_BITS 2) -----------------------------

_F = {"0_298631336": 2446, "0_390180644": 3196, "0_541196100": 4433, "0_765366865": 6270,
      "0_899976223": 7373, "1_175875602": 9633, "1_501321110": 12299, "1_847759065": 15137,
      "1_961570560": 16069, "2_053119869": 16819, "2_562915447": 20995, "3_072711026": 25172}


def _idct_1d(x, shift: int):
    """One pass of the islow IDCT over the 8 inputs ``x[k]`` (arrays);
    returns the 8 outputs descaled by ``shift`` bits."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * _F["0_541196100"]
    tmp2 = z1 - z3 * _F["1_847759065"]
    tmp3 = z1 + z2 * _F["0_765366865"]
    tmp0 = (x[0] + x[4]) << 13
    tmp1 = (x[0] - x[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F["1_175875602"]
    t0 = t0 * _F["0_298631336"]
    t1 = t1 * _F["2_053119869"]
    t2 = t2 * _F["3_072711026"]
    t3 = t3 * _F["1_501321110"]
    z1 = z1 * -_F["0_899976223"]
    z2 = z2 * -_F["2_562915447"]
    z3 = z3 * -_F["1_961570560"] + z5
    z4 = z4 * -_F["0_390180644"] + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4

    half = 1 << (shift - 1)
    return [(tmp10 + t3 + half) >> shift, (tmp11 + t2 + half) >> shift,
            (tmp12 + t1 + half) >> shift, (tmp13 + t0 + half) >> shift,
            (tmp13 - t0 + half) >> shift, (tmp12 - t1 + half) >> shift,
            (tmp11 - t2 + half) >> shift, (tmp10 - t3 + half) >> shift]


def idct_islow(coefs: np.ndarray) -> np.ndarray:
    """(n, 8, 8) dequantized coefficients (natural order, int64) -> (n, 8, 8)
    uint8 samples, as libjpeg's ``jpeg_idct_islow`` computes them."""
    ws = np.stack(_idct_1d([coefs[:, k, :] for k in range(8)], 13 - 2), axis=1)
    out = np.stack(_idct_1d([ws[:, :, k] for k in range(8)], 13 + 2 + 3), axis=2)
    return np.clip(out + 128, 0, 255).astype(np.uint8)


# -- upsampling and colour (jdsample.c, jdcolor.c) -------------------------------

def _up_h(x: np.ndarray, bias: Tuple[int, int], shift: int) -> np.ndarray:
    """Width doubled: sample 2j from 3 x[j] + x[j-1], 2j+1 from 3 x[j] +
    x[j+1] (edges replicated), plus ``bias`` and shifted right by ``shift``."""
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int32)
    out[:, 0::2] = (3 * x + left + bias[0]) >> shift
    out[:, 1::2] = (3 * x + right + bias[1]) >> shift
    return out


def _up_v(x: np.ndarray):
    """(3 x[i] + x[i-1], 3 x[i] + x[i+1]) of each row, edges replicated."""
    above = np.concatenate([x[:1], x[:-1]], axis=0)
    below = np.concatenate([x[1:], x[-1:]], axis=0)
    return 3 * x + above, 3 * x + below


def upsample(plane: np.ndarray, fy: int, fx: int) -> np.ndarray:
    """A component's real samples (h, w) upsampled ``fy`` x ``fx`` (1 or 2)
    as libjpeg-turbo does by default: fancy for h2v1 and h2v2 when w > 2,
    for h1v2 always, else by replication."""
    x = plane.astype(np.int32)
    w = x.shape[1]
    if (fy, fx) == (1, 1):
        return x
    if (fy, fx) == (1, 2):
        return _up_h(x, (1, 2), 2) if w > 2 else np.repeat(x, 2, axis=1)
    if (fy, fx) == (2, 1):
        a, b = _up_v(x)
        out = np.empty((2 * x.shape[0], w), np.int32)
        out[0::2], out[1::2] = (a + 1) >> 2, (b + 2) >> 2
        return out
    if w <= 2:
        return np.repeat(np.repeat(x, 2, axis=0), 2, axis=1)
    a, b = _up_v(x)
    out = np.empty((2 * x.shape[0], 2 * w), np.int32)
    out[0::2], out[1::2] = _up_h(a, (8, 7), 4), _up_h(b, (8, 7), 4)
    return out


def _fix(x: float) -> int:
    return int(x * (1 << 16) + 0.5)


_CX = np.arange(256) - 128
_CR_R = (_fix(1.40200) * _CX + (1 << 15)) >> 16
_CB_B = (_fix(1.77200) * _CX + (1 << 15)) >> 16
_CR_G = -_fix(0.71414) * _CX
_CB_G = -_fix(0.34414) * _CX + (1 << 15)


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """libjpeg's ``ycc_rgb_convert`` (16-bit fixed point, table rounding)."""
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


# -- the decoder -----------------------------------------------------------------

def decode_jpeg(data: bytes) -> np.ndarray:
    """A baseline JPEG -> (H, W, 3) uint8 RGB (gray repeated, as PIL's
    ``convert("RGB")``)."""
    if data[:2] != JPEG_MAGIC:
        raise ValueError("not a JPEG (no SOI marker)")
    qt: Dict[int, np.ndarray] = {}
    dc: Dict[int, tuple] = {}
    ac: Dict[int, tuple] = {}
    frame = None
    restart = 0
    adobe = jfif = None
    coefs: Dict[int, np.ndarray] = {}  # component index -> (rows, cols, 64) zigzag
    comp_q: Dict[int, np.ndarray] = {}
    pos = 2

    def read(n: int) -> bytes:
        nonlocal pos
        out = data[pos:pos + n]
        pos += len(out)
        return out

    while frame is None or len(coefs) < len(frame[2]) or data.find(b"\xff\xda", pos) >= 0:
        for marker, body in _segments(read):
            if marker == 0xDB:
                i = 0
                while i < len(body):
                    pq, tq = body[i] >> 4, body[i] & 15
                    vals = np.frombuffer(body, ">u2" if pq else np.uint8, 64, i + 1)
                    qt[tq] = np.zeros(64, np.int64)
                    qt[tq][ZIGZAG] = vals
                    i += 129 if pq else 65
            elif marker == 0xC4:
                i = 0
                while i < len(body):
                    tc, th = body[i] >> 4, body[i] & 15
                    spec, i = _table_spec(body, i)
                    (ac if tc else dc)[th] = _peek_tables(spec)
            elif marker == 0xDD:
                (restart,) = struct.unpack(">H", body[:2])
            elif marker == 0xE0 and body[:5] == b"JFIF\x00":
                jfif = True
            elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
                adobe = body[11]
            elif _is_frame(marker) or marker == 0xCC:
                problem = (_frame_problem(marker, body) if marker != 0xCC
                           else "an arithmetic-coded JPEG (DAC)")
                if problem:
                    raise ValueError(f"{problem}: the numpy decoder reads baseline "
                                     f"(sequential Huffman, 8-bit, 1 or 3 components) JPEGs")
                _, height, width, ncomp = struct.unpack(">BHHB", body[:6])
                if height == 0 or width == 0:
                    raise ValueError("JPEG of zero height (DNL) or width")
                frame = (height, width, [(body[6 + 3 * i], body[7 + 3 * i] >> 4,
                                          body[7 + 3 * i] & 15, body[8 + 3 * i])
                                         for i in range(ncomp)])
            elif marker == 0xDA:
                if frame is None:
                    raise ValueError("JPEG scan before its frame header")
                pos = _scan(data, pos, body, frame, restart, qt, dc, ac, coefs, comp_q)
            elif marker == 0xD9:
                if frame is None or len(coefs) < len(frame[2]):
                    raise ValueError("JPEG ends (EOI) before every component was scanned")
                return _assemble(frame, coefs, comp_q, adobe, jfif)
    return _assemble(frame, coefs, comp_q, adobe, jfif)


def _scan(data: bytes, pos: int, body: bytes, frame, restart: int, qt, dc, ac, coefs,
          comp_q) -> int:
    """Decode the scan whose SOS ``body`` ends at ``pos`` into ``coefs``;
    returns the position of the marker after its data."""
    height, width, comps = frame
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    ids = {c[0]: i for i, c in enumerate(comps)}
    ns = body[0]
    try:
        scan = [(ids[body[1 + 2 * j]], body[2 + 2 * j] >> 4, body[2 + 2 * j] & 15)
                for j in range(ns)]
        tabs = ([dc[t] for _, t, _ in scan], [ac[t] for _, _, t in scan])
        for ci, _, _ in scan:
            if ci not in coefs:
                _, h, v, tq = comps[ci]
                comp_q[ci] = qt[tq]
                coefs[ci] = np.zeros((mcuy * v, mcux * h, 64), np.int64)
    except KeyError as e:
        raise ValueError(f"JPEG scan names a component or table that is not defined ({e})") \
            from None
    ss, se = body[1 + 2 * ns], body[2 + 2 * ns]
    if (ss, se) != (0, 63):
        raise ValueError(f"JPEG scan of spectral range {ss}..{se}: not a sequential one")
    # where each block of an MCU goes: (component, rows, cols) over the MCUs
    if ns == 1:  # non-interleaved: an MCU is one block of the component's own grid
        ci = scan[0][0]
        _, h, v, _ = comps[ci]
        bw = -(-(-(-width * h // hmax)) // 8)
        bh = -(-(-(-height * v // vmax)) // 8)
        slots, n_mcus = [0], bw * bh
        where = [(ci, np.arange(n_mcus) // bw, np.arange(n_mcus) % bw)]
    else:
        slots, where = [], []
        my, mx = np.divmod(np.arange(mcux * mcuy), mcux)
        for j, (ci, _, _) in enumerate(scan):
            _, h, v, _ = comps[ci]
            for dy in range(v):
                for dx in range(h):
                    slots.append(j)
                    where.append((ci, my * v + dy, mx * h + dx))
        n_mcus = mcux * mcuy
    win, seg, end = _scan_bits(data, pos)
    blocks = _decode_scan(win, seg, slots, n_mcus, restart, *tabs)
    blocks = blocks.reshape(n_mcus, len(slots), 64)
    for k, (ci, rows, cols) in enumerate(where):
        coefs[ci][rows, cols] = blocks[:, k]
    return end


def _assemble(frame, coefs, comp_q, adobe, jfif) -> np.ndarray:
    """Dequantize, IDCT, crop each component to its real samples, upsample,
    crop to the image, convert to RGB."""
    height, width, comps = frame
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    planes = []
    for ci, (cid, h, v, _) in enumerate(comps):
        blocks = coefs[ci]
        rows, cols = blocks.shape[:2]
        nat = np.zeros((rows * cols, 64), np.int64)
        nat[:, ZIGZAG] = blocks.reshape(-1, 64)
        px = idct_islow((nat * comp_q[ci]).reshape(-1, 8, 8))
        plane = px.reshape(rows, cols, 8, 8).transpose(0, 2, 1, 3).reshape(rows * 8, cols * 8)
        dh, dw = -(-height * v // vmax), -(-width * h // hmax)
        planes.append(upsample(plane[:dh, :dw], vmax // v, hmax // h)[:height, :width])
    if len(comps) == 1:
        return np.repeat(planes[0].astype(np.uint8)[..., None], 3, axis=2)
    ids = tuple(c[0] for c in comps)
    rgb = (adobe == 0) if adobe is not None else (not jfif and ids == (82, 71, 66))
    if rgb:
        return np.stack(planes, axis=-1).astype(np.uint8)
    return ycc_to_rgb(*planes)
