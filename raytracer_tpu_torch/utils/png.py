"""Minimal PNG (8-bit RGB) writer, stdlib only (zlib + struct).

A copy of ``raytracer_tpu/utils/png.py``: the same bytes for the same
image.  The reference writes only ASCII P3 PPM; PNG holds the same
pixels in a file ~50x smaller.  The encoding is deliberately simple: one
IDAT chunk, filter type 0 (None) on every scanline.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def write_png(filename: str, data: np.ndarray, compress_level: int = 6) -> None:
    """Write an (H, W, 3) uint8 array as an 8-bit truecolor PNG."""
    data = np.asarray(data)
    if data.ndim != 3 or data.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) image, got {data.shape}")
    if data.dtype != np.uint8:
        raise ValueError(f"expected uint8 image, got {data.dtype}")
    h, w, _ = data.shape
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    # filter byte 0 (None) prepended to each scanline
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), data.reshape(h, w * 3)], axis=1
    ).tobytes()
    idat = zlib.compress(raw, compress_level)
    with open(filename, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", idat))
        f.write(_chunk(b"IEND", b""))


def read_png(filename: str) -> np.ndarray:
    """Read back a PNG written by :func:`write_png` (8-bit RGB, filters
    0/1/2 only — enough for our own output and a round-trip test)."""
    with open(filename, "rb") as f:
        raw = f.read()
    if raw[:8] != _SIGNATURE:
        raise ValueError(f"{filename}: not a PNG")
    pos, w = 8, None
    idat = b""
    while pos < len(raw):
        (length,) = struct.unpack(">I", raw[pos : pos + 4])
        tag = raw[pos + 4 : pos + 8]
        payload = raw[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", payload[:10])
            if (depth, color) != (8, 2):
                raise ValueError(f"{filename}: only 8-bit RGB supported")
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
        pos += 12 + length
    if w is None:
        raise ValueError(f"{filename}: missing IHDR")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * 3)
    out = np.empty((h, w * 3), np.int32)
    prev = np.zeros(w * 3, np.int32)
    for y in range(h):
        filt, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if filt == 0:
            cur = line
        elif filt == 2:  # Up
            cur = (line + prev) & 0xFF
        elif filt == 1:  # Sub (bpp = 3)
            cur = line.copy()
            for x in range(3, w * 3):
                cur[x] = (cur[x] + cur[x - 3]) & 0xFF
        else:
            raise ValueError(f"{filename}: unsupported filter {filt}")
        out[y] = cur
        prev = cur
    return out.astype(np.uint8).reshape(h, w, 3)
