"""A minimal PNG writer on zlib: 8-bit grayscale or RGB pixels, each row
behind a filter byte of 0, the image data in one IDAT chunk. The web
page's slice viewer (``serve.encode_gray_png``) and the attention maps
(``eval/attention_viz.py``) write with it."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def encode_png(pixels: np.ndarray) -> bytes:
    """The PNG of (H, W) grayscale or (H, W, 3) RGB uint8 ``pixels``."""
    h, w = pixels.shape[:2]
    colour = 0 if pixels.ndim == 2 else 2
    raw = b"".join(b"\x00" + pixels[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data +
                struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) +
            chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
