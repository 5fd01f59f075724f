"""A minimal PNG writer (8-bit RGB or grey, no filtering) on ``zlib`` and
``struct``, for machines without PIL or imageio."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3) or (H, W) uint8 -> the bytes of a PNG file."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in (1, 3):
        raise ValueError(f"PNG writer takes 1 or 3 channels, got {c}")
    # each scanline starts with filter type 0 (None)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 0, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(raw, 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
