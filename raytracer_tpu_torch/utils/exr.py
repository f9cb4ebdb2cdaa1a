"""Minimal OpenEXR 2.0 scanline writer/reader (uncompressed RGB).

A copy of ``raytracer_tpu/utils/exr.py``: the same bytes for the same
radiance.  It stores the renderer's linear float radiance before
quantization (the reference's only output is 8-bit PPM).

Scope, stdlib and numpy only: single-part scanline files,
``NO_COMPRESSION``, channels B/G/R in the spec's alphabetical order, HALF
or FLOAT pixels.  The reader exists so tests (and
``raytracer_tpu_torch.compare``) can check files without a decoder.

Format (public spec, openexr.com "OpenEXR File Layout"): magic int32
20000630, version int32 2, then a header of ``name\\0 type\\0
size<int32> value`` attributes ended by ``\\0``; a table of int64 file
offsets, one per scanline block; each block is ``y<int32>
bytecount<int32>`` and then, for every channel in header order, that
channel's full row of pixel values.
"""

from __future__ import annotations

import struct

import numpy as np

_MAGIC = 20000630
_VERSION = 2
# pixel-type enum per spec: 0=UINT, 1=HALF, 2=FLOAT
_HALF, _FLOAT = 1, 2


def _attr(name: str, typ: str, value: bytes) -> bytes:
    return (name.encode() + b"\0" + typ.encode() + b"\0"
            + struct.pack("<i", len(value)) + value)


def _channel_list(ptype: int) -> bytes:
    chan = b""
    for name in (b"B", b"G", b"R"):  # spec: sorted alphabetically
        chan += name + b"\0" + struct.pack("<i", ptype)
        chan += struct.pack("<BBBB", 0, 0, 0, 0)   # pLinear + 3 reserved
        chan += struct.pack("<ii", 1, 1)           # xSampling, ySampling
    return chan + b"\0"


def write_exr(path: str, color, half: bool = True) -> None:
    """Write (H, W, 3) linear float RGB radiance as a scanline EXR.

    ``half=True`` stores float16 channels (the EXR-native format, half the
    bytes); ``half=False`` stores full float32.  Values are written as-is:
    no clamp, no quantization, no transfer curve.
    """
    img = np.asarray(color, np.float32)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) color, got {img.shape}")
    h, w, _ = img.shape
    ptype = _HALF if half else _FLOAT
    pix = img.astype(np.float16) if half else img
    psz = pix.dtype.itemsize

    header = b"".join((
        _attr("channels", "chlist", _channel_list(ptype)),
        _attr("compression", "compression", struct.pack("<B", 0)),
        _attr("dataWindow", "box2i", struct.pack("<iiii", 0, 0, w - 1, h - 1)),
        _attr("displayWindow", "box2i",
              struct.pack("<iiii", 0, 0, w - 1, h - 1)),
        _attr("lineOrder", "lineOrder", struct.pack("<B", 0)),  # increasing y
        _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
        _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0)),
        _attr("screenWindowWidth", "float", struct.pack("<f", 1.0)),
    )) + b"\0"

    row_bytes = 8 + 3 * w * psz  # y + bytecount + B,G,R rows
    table_at = 8 + len(header)
    data_at = table_at + 8 * h
    offsets = struct.pack(f"<{h}q", *(data_at + y * row_bytes
                                      for y in range(h)))
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _MAGIC, _VERSION))
        f.write(header)
        f.write(offsets)
        for y in range(h):
            f.write(struct.pack("<ii", y, 3 * w * psz))
            # channel order B, G, R (header order), full row each
            f.write(pix[y, :, 2].tobytes())
            f.write(pix[y, :, 1].tobytes())
            f.write(pix[y, :, 0].tobytes())


def read_exr(path: str) -> np.ndarray:
    """Read a scanline EXR written by :func:`write_exr` (or any
    single-part uncompressed B/G/R scanline file) → (H, W, 3) float32."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError("not an EXR file")
    if version & 0x200:
        raise ValueError("multi-part EXR not supported")

    pos = 8
    attrs = {}
    while buf[pos] != 0:
        nul = buf.index(b"\0", pos)
        name = buf[pos:nul].decode()
        pos = nul + 1
        nul = buf.index(b"\0", pos)
        typ = buf[pos:nul].decode()
        pos = nul + 1
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        attrs[name] = (typ, buf[pos:pos + size])
        pos += size
    pos += 1  # header terminator

    if attrs["compression"][1][0] != 0:
        raise ValueError("only NO_COMPRESSION files supported")
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1

    chans = []  # (name, numpy dtype) in header order
    cl, cpos = attrs["channels"][1], 0
    while cl[cpos] != 0:
        nul = cl.index(b"\0", cpos)
        cname = cl[cpos:nul].decode()
        (ptype,) = struct.unpack_from("<i", cl, nul + 1)
        if ptype not in (_HALF, _FLOAT):
            raise ValueError(f"unsupported pixel type {ptype}")
        chans.append((cname, np.float16 if ptype == _HALF else np.float32))
        cpos = nul + 1 + 16
    if sorted(n for n, _ in chans) != ["B", "G", "R"]:
        raise ValueError(f"expected B/G/R channels, got {chans}")

    pos += 8 * h  # skip the offset table; blocks follow in line order
    out = np.empty((h, 3, w), np.float32)
    col = {"R": 0, "G": 1, "B": 2}
    for _ in range(h):
        y, nbytes = struct.unpack_from("<ii", buf, pos)
        pos += 8
        for cname, dt in chans:
            n = w * np.dtype(dt).itemsize
            out[y - y0, col[cname]] = np.frombuffer(
                buf, dt, count=w, offset=pos).astype(np.float32)
            pos += n
    return out.transpose(0, 2, 1)
