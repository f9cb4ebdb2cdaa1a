"""ASCII PPM (P3) image I/O.

A copy of ``raytracer_tpu/utils/ppm.py``.  The writer is byte-compatible
with the reference writer (the course's ``ppm.cpp:4-39``): header
``P3\\n<w> <h>\\n255\\n``, one text row per pixel row, every value followed
by a single space EXCEPT the last channel of each row, and a newline
terminating each row.
"""

from __future__ import annotations

import numpy as np


def write_ppm(filename: str, data: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as an ASCII P3 PPM."""
    data = np.asarray(data)
    if data.ndim != 3 or data.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) image, got {data.shape}")
    if data.dtype != np.uint8:
        raise ValueError(f"expected uint8 image, got {data.dtype}")
    h, w, _ = data.shape

    # fast path: the tracked C++ writer (native/raytracer_native.cpp,
    # byte-identical to the Python loop below)
    from raytracer_tpu_torch.utils.native import load

    lib = load()
    if lib is not None:
        import ctypes

        cdata = np.ascontiguousarray(data)
        rc = lib.rt_write_ppm(
            filename.encode(),
            cdata.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            w, h,
        )
        if rc == 0:
            return
        raise OSError(f"native PPM writer failed for {filename}")

    flat = data.reshape(h, w * 3)
    with open(filename, "w") as f:
        f.write(f"P3\n{w} {h}\n255\n")
        for row in flat:
            f.write(" ".join(str(int(v)) for v in row))
            f.write("\n")


def read_ppm(filename: str) -> np.ndarray:
    """Read an ASCII P3 PPM into an (H, W, 3) uint8 array (arbitrary
    whitespace and ``#`` comments allowed, as the P3 spec does)."""
    with open(filename, "rb") as f:
        raw = f.read()
    lines = []
    for line in raw.split(b"\n"):
        hash_idx = line.find(b"#")
        if hash_idx >= 0:
            line = line[:hash_idx]
        lines.append(line)
    tokens = b"\n".join(lines).split()
    if not tokens or tokens[0] != b"P3":
        raise ValueError(f"{filename}: not an ASCII P3 PPM")
    w, h, maxval = int(tokens[1]), int(tokens[2]), int(tokens[3])
    if maxval != 255:
        raise ValueError(f"{filename}: expected maxval 255, got {maxval}")
    vals = np.array(tokens[4 : 4 + w * h * 3], dtype=np.int64)
    if vals.size != w * h * 3:
        raise ValueError(f"{filename}: expected {w*h*3} values, got {vals.size}")
    return vals.reshape(h, w, 3).astype(np.uint8)
