"""ctypes loader for the tracked native host library
(``native/libraytracer_native.so``: BVH build and PPM writer).

A copy of ``raytracer_tpu/utils/native.py`` that only LOADS the tracked
library and never runs ``make`` into ``native/``.  Every caller has a
bit-identical numpy fallback, so a library that does not load here
(another libc, another architecture) changes speed, not results.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native", "libraytracer_native.so",
)

_lock = threading.Lock()
_state: dict = {}


def load() -> Optional[ctypes.CDLL]:
    """The native library, or None when it is absent or does not load."""
    with _lock:
        if "lib" not in _state:
            _state["lib"] = _open()
        return _state["lib"]


def _open() -> Optional[ctypes.CDLL]:
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.rt_build_bvh.restype = ctypes.c_int
    lib.rt_build_bvh.argtypes = [
        ctypes.c_int, f32p, f32p, f32p, i32p, ctypes.c_int, ctypes.c_int,
        f32p, f32p, i32p, i32p, i32p, i32p, i32p, ctypes.c_int,
    ]
    lib.rt_write_ppm.restype = ctypes.c_int
    lib.rt_write_ppm.argtypes = [
        ctypes.c_char_p, u8p, ctypes.c_int, ctypes.c_int,
    ]
    return lib
