"""Device resolution and the hand-written CUDA kernel library.

Entry points take ``device="cuda"`` by default and raise when no GPU is
present; ``device="cpu"`` is the explicit request for the plain PyTorch
versions of the kernels (``ops.kernels``), which the CPU tests use.

The kernels are CUDA C++ sources in ``csrc/*.cu``.  At first use they are
compiled by ``nvcc`` for ``sm_90a`` (one process per source, all started
together), linked into one shared library under ``_build/`` (listed in
``.gitignore``) and loaded with ctypes.  The library's file name carries
a hash of the sources and flags, so an edited source is rebuilt.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

from raytracer_tpu_torch import tracing

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

# IEEE rounding op for op, like PyTorch's eager elementwise ops: no fast
# math, and no contraction of a*b+c into an FMA (-fmad=false), so each
# kernel can be held EQUAL to its plain version on the card
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC",
]

_vp, _i = ctypes.c_void_p, ctypes.c_int
# C entry points (csrc/*.cu); each but rt_launch_threads and
# rt_ray_mask_hier_group returns cudaGetLastError()
SIGNATURES = {
    # act, box, bundle, hit, ent, nt, c, r, stream
    "rt_ray_mask": [_vp] * 5 + [_i] * 3 + [_vp],
    # act, sup, box, bundle, hit, ent, nt, c, r, stream
    "rt_ray_mask_hier": [_vp] * 6 + [_i] * 3 + [_vp],
    # hit, hit row stride, entry, entry row stride, words, ids, elist,
    # counts, tally (or null), nt, c, max_list, stream
    "rt_compact": [_vp, ctypes.c_longlong, _vp, ctypes.c_longlong]
                  + [_vp] * 5 + [_i] * 3 + [_vp],
    # origin, dirs, active (or null), cmin, cmax, t_hi (or null), hit,
    # entry, nt, c, tile, subsplit, stream
    "rt_tile_mask": [_vp] * 8 + [_i] * 4 + [_vp],
    # tw, tl, tc, sw, sl, sc, origin, dirs, tri_dat, sph_dat, t, slot,
    # nt, ct, cs, pt, ps, wt, ws, shared_origin, bfc, stream
    "rt_closest": [_vp] * 12 + [_i] * 9 + [_vp],
    # tw, tl, tc, sw, sl, sc, lps, origin, planes, sph_dat, found,
    # nt, nl, ct, cs, pt, ps, wt, ws, relaxed, stream
    "rt_shadow": [_vp] * 11 + [_i] * 9 + [_vp],
    # tw, tl, tc, sw, sl, sc, origin, dirs, t_max, tri_dat, sph_dat, found,
    # nt, ct, cs, pt, ps, wt, ws, bfc, relaxed, stream
    "rt_any": [_vp] * 12 + [_i] * 9 + [_vp],
    # nt; returns the threads per block of a closest, any-hit or shadow
    # launch over nt tiles (a number, not an error)
    "rt_launch_threads": [_i],
    # nt, c; returns the chunks per block of a hierarchical mask launch
    # over nt tiles of c columns (a number, not an error)
    "rt_ray_mask_hier_group": [_i, _i],
    # key (2 int64 words on the device), lo, hi, out, n, stream
    "rt_threefry_uniform": [_vp, ctypes.c_float, ctypes.c_float, _vp,
                            ctypes.c_longlong, _vp],
    # t, slot, origin, dirs, active, pack, sph, lps, hit, normal, mat,
    # point, offset, mask, r, pt, ps, n_small, nl, shared_origin, eps,
    # relevant_cos, stream
    "rt_hit_record": [_vp] * 14 + [_i] * 6 + [ctypes.c_float] * 2 + [_vp],
    # color, tp, active, org, dir (in), hit, normal, mat, point, offset,
    # occ, mat_ambient, mat_diffuse, mat_specular, mat_mirror, mat_phong,
    # mat_is_mirror, lps, lint, ambient_light, background, sph, color, tp,
    # active, org, dir (out), r, nl, ps, n_small, shared_origin, first,
    # inplace, relaxed, relevant_cos, rad_to_deg, gate_deg, stream
    "rt_shade_bounce": [_vp] * 27 + [_i] * 8 + [ctypes.c_float] * 3 + [_vp],
}

_lock = threading.Lock()
_state: dict = {}


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for an entry point's ``device`` argument.  CUDA
    (the default) raises when no GPU is present: the port never carries
    on on the CPU unless the caller asked for it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the GPU "
                "unless device='cpu' (--device cpu) is passed")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: cuda or cpu")
    return dev


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "csrc/ at first use and need the CUDA toolkit")
    return found


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libraytracer_kernels-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile csrc/*.cu (in parallel) and link the kernel library;
    returns its path.  A no-op when the library for these sources exists."""
    out = library_path()
    if not os.path.exists(out):
        compile_library(CSRC_DIR, out, os.path.join(BUILD_DIR, "build.log"))
    return out


def compile_library(csrc: str, out: str, log_path: str) -> None:
    """Compile every ``*.cu`` in ``csrc`` (one nvcc each, all started
    together) and link them into the shared library ``out``; the
    compilers' output, with ptxas' registers per kernel, goes to
    ``log_path``."""
    nvcc = _nvcc()
    os.makedirs(os.path.dirname(out), exist_ok=True)
    cu = sorted(glob.glob(os.path.join(csrc, "*.cu")))
    with tempfile.TemporaryDirectory(dir=os.path.dirname(out)) as tmp:
        objs, procs = [], []
        for src in cu:
            obj = os.path.join(tmp, os.path.basename(src)[:-3] + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", src, "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, p in procs:
            log, _ = p.communicate()
            logs.append(f"== {os.path.basename(src)}\n{log}")
            if p.returncode != 0:
                failed.append(src)
        with open(log_path, "w") as f:
            f.write("\n".join(logs))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(logs))
        tmp_lib = os.path.join(tmp, "lib.so")
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp_lib, *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        os.replace(tmp_lib, out)


def load_library(path: str) -> ctypes.CDLL:
    """Load the kernel library at ``path`` and route the wrappers of
    ``ops.kernels`` to it; returns it.  A library built from an older
    ``csrc`` (an A/B base) may lack the newer entry points."""
    lib = ctypes.CDLL(path)
    for name, argtypes in SIGNATURES.items():
        if not hasattr(lib, name):
            continue
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.rt_error_string.argtypes = [ctypes.c_int]
    lib.rt_error_string.restype = ctypes.c_char_p
    _state["lib"] = lib
    return lib


def kernels() -> ctypes.CDLL:
    """The loaded kernel library (built and loaded at first use, in the
    set-up span ``backend.load``)."""
    with _lock:
        if "lib" not in _state:
            with tracing.setup_span("backend.load"):
                load_library(build())
        return _state["lib"]


def build_seconds() -> float:
    """Seconds the first ``kernels()`` call took (build and load): its
    ``backend.load`` span."""
    return tracing.seconds("backend.load")


def launch_threads(nt: int) -> int:
    """Threads per block of a closest-hit, any-hit or shadow launch over
    ``nt`` tiles: wide blocks for launches of few tiles per SM
    (``wide_launch`` in csrc/common.cuh)."""
    return kernels().rt_launch_threads(nt)


def mask_hier_group(nt: int, c: int) -> int:
    """Chunks per block of a hierarchical mask launch over ``nt`` tiles of
    ``c`` columns (``hier_group`` in csrc/ray_mask.cu)."""
    return kernels().rt_ray_mask_hier_group(nt, c)


def check(rc: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        msg = _state["lib"].rt_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} {msg}")
