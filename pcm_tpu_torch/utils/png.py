"""An 8-bit RGB PNG writer on the standard library (the server's images,
``generate``'s files and the trainer's validation grids)."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def png_bytes(img: np.ndarray) -> bytes:
    """Encode an (H, W, 3) uint8 image as PNG (8-bit RGB, no filtering)."""
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(kind: bytes, data: bytes) -> bytes:
        body = kind + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def to_uint8(images: np.ndarray) -> np.ndarray:
    """Images in [-1, 1] -> uint8, as the JAX scripts convert them:
    ``clip((x + 1) * 127.5, 0, 255)`` in fp32, truncated."""
    return np.clip((np.asarray(images, np.float32) + 1) * 127.5, 0, 255).astype(np.uint8)


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(np.ascontiguousarray(img)))
