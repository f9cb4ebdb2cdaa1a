#!/usr/bin/env python3
"""GPU smoke test of raytracer_tpu_torch, the PyTorch/CUDA port.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the CUDA kernels from raytracer_tpu_torch/csrc (nvcc, sm_90a),
then:

1. set-up: build time, the card's name and power limit;
2. entry scene: tests/data/entry_scene.xml through the CLI's ``main`` on
   CUDA at --ssaa 1 and 2, against the same runs with --device cpu (the
   plain PyTorch versions of the kernels);
3. full width: ``terrain_scene(cells=126, res=1024, mirror_stripes=True)``
   (31,752 triangles, 2 lights, mirrors) rendered at --ssaa 2 (4,194,304
   rays, one whole frame) through ``render_one_camera``: build time, warm
   ms/frame, Mrays/s, each kernel's launches in one frame (all > 0), NaN
   check and non-background share, one frame under torch.profiler (device
   time by kernel, idle share); the same scene through a 64x64 camera
   against the CPU render;
4. each kernel against its plain version ON THE CARD, on the real inputs
   captured from the phase-3 waves (and from two sphere fields: the
   sphere walk with its early exit and the single-light shadow, and the
   dense sphere rows, each also rendered at 64x64 on CUDA and on the CPU
   and compared; the 64x64 terrain camera gives tiles whose shortlists
   overflow into the bitmask scan), on a sample of >= 256 tiles, with the
   other template instance too (bfc for closest, relaxed for shadow):
   results must be EQUAL (the kernels round op for op like eager
   PyTorch, -fmad=false);
5. timings of each kernel at the phase-3 shapes with its bound;

and prints the kernels' JSON line, then ``{"ok": true, "device": ...}``
as its last line.  Any failure exits non-zero without that line.  Images
and a results.json land in smoke_out/ (git-ignored).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "smoke_out")

# published H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor
# cores and HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

# float operations per (ray, primitive-or-box) pair, counted from the
# kernel sources: csrc/ray_mask.cu (6 mul, 6 sub, 12 min/max, 3 compare,
# 1 min), csrc/closest.cu (triangle: 15 mul/add for nd and the two
# edge-direction dots, 9 for the origin dots (3 per lane with a shared
# origin, counted per pair as 0), 1 sub, 1 div, 4 for beta/gamma, 2 for
# alpha, 4 compares, 2 for the winner; sphere: 3 sub, 6 dot, 1 mul, 6
# for c_q, 4 for disc, 1 max, 1 sqrt, 3 for t1, 1 div, 5 compares, 2 for
# the winner), csrc/shadow.cu (4 planes x 6, 3 min, 2 compares; sphere as
# in closest without the winner)
OPS = {"ray_mask": 28, "tri": 43, "tri_shared": 34, "sph": 33,
       "plane": 29, "sph_shadow": 31}

REPLACES = {
    "ray_mask": "raytracer_tpu/ops/cluster_trace.py:305",
    "closest_shared": "raytracer_tpu/ops/cluster_trace.py:720",
    "closest": "raytracer_tpu/ops/cluster_trace.py:720",
    "shadow": "raytracer_tpu/ops/cluster_trace.py:1135",
}
SOURCES = {
    "ray_mask": "raytracer_tpu_torch/csrc/ray_mask.cu",
    "closest_shared": "raytracer_tpu_torch/csrc/closest.cu",
    "closest": "raytracer_tpu_torch/csrc/closest.cu",
    "shadow": "raytracer_tpu_torch/csrc/shadow.cu",
}


class Failure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise Failure(msg)


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


def compare_images(a, b, what):
    """The repo's engine bar: at most 4 pixels differ by > 1 LSB."""
    import numpy as np

    d = np.abs(a.astype(int) - b.astype(int)).max(-1)
    n_bad = int((d > 1).sum())
    log(f"  {what}: max |diff| {int(d.max())}, pixels > 1 LSB: {n_bad}")
    check(a.shape == b.shape, f"{what}: shapes {a.shape} vs {b.shape}")
    check(n_bad <= 4, f"{what}: {n_bad} pixels differ by > 1 LSB")


def compare_radiance(a, b, what):
    """rtol 1e-4 / atol 1e-3 on every pixel but at most 4 (exact-t tie and
    grazing pixels)."""
    import torch

    a, b = a.cpu(), b.cpu()
    check(bool(torch.isfinite(a).all()), f"{what}: non-finite radiance")
    close = torch.isclose(a, b, rtol=1e-4, atol=1e-3).all(-1)
    n_bad = int((~close).sum())
    log(f"  {what}: radiance pixels outside rtol 1e-4/atol 1e-3: {n_bad}")
    check(n_bad <= 4, f"{what}: {n_bad} radiance pixels differ")


# ---------------------------------------------------------------------------
# kernel input capture and comparison
# ---------------------------------------------------------------------------

class Capture:
    """Wraps the three kernel wrappers of ops.kernels and keeps the inputs
    of the first call of each shape: shared-origin closest (bounce 0), the
    first per-ray-origin closest (bounce 1), the mask that precedes it,
    and the first shadow call."""

    def __init__(self, kernels):
        self.k = kernels
        self.orig = {n: getattr(kernels, n) for n in ("ray_mask", "closest", "shadow")}
        self.calls = {}
        self.last_mask = None

    def __enter__(self):
        k, orig, calls = self.k, self.orig, self.calls

        def ray_mask(*a):
            self.last_mask = a
            calls.setdefault("ray_mask_first", a)
            return orig["ray_mask"](*a)

        def closest(*a):
            shared = a[6].dim() == 1
            name = "closest_shared" if shared else "closest"
            if name not in calls:
                calls[name] = a
                if not shared:
                    calls["ray_mask"] = self.last_mask
            return orig["closest"](*a)

        def shadow(*a):
            calls.setdefault("shadow", a)
            return orig["shadow"](*a)

        k.ray_mask, k.closest, k.shadow = ray_mask, closest, shadow
        return self

    def __exit__(self, *exc):
        for n, f in self.orig.items():
            setattr(self.k, n, f)


def sample_tiles(counts, n, gen):
    """>= n tile ids with work (all of them when fewer), including every
    tile whose list overflowed (it takes the bitmask scan)."""
    import torch

    work = torch.nonzero(counts > 0).flatten()
    over = torch.nonzero(counts > 48).flatten()[:n // 4]
    if work.numel() > n:
        work = work[torch.randperm(work.numel(), generator=gen,
                                   device="cpu").to(work.device)[:n]]
    return torch.unique(torch.cat([work, over]))


def slice_mask_args(a, tiles):
    act, box, bundle = a
    nt = act.shape[0]
    b = bundle.view(8, nt, 128)[:, tiles].reshape(8, -1).contiguous()
    return act[tiles].contiguous(), box, b


def _rows(x, nt, tiles):
    return x.view(nt, -1)[tiles].reshape(-1).contiguous()


def slice_closest_args(a, tiles):
    tw, tl, tc, sw, sl, sc, origin, dirs, tri, sph, bfc = a
    nt = tc.shape[0]
    sl_ = [_rows(x, nt, tiles) for x in (tw, tl, tc, sw, sl, sc)]
    if origin.dim() == 2:
        origin = origin.view(nt, 128, 3)[tiles].reshape(-1, 3).contiguous()
    d = dirs.view(nt, 128, 3)[tiles].reshape(-1, 3).contiguous()
    return (*sl_, origin, d, tri, sph, bfc)


def slice_shadow_args(a, tiles):
    import torch

    tw, tl, tc, sw, sl, sc, lps, origin, planes, sph, relaxed = a
    nl, nt = tc.shape
    sl_ = [torch.stack([_rows(x[l], nt, tiles) for l in range(nl)])
           for x in (tw, tl, tc, sw, sl, sc)]
    o = origin.view(nt, 128, 3)[tiles].reshape(-1, 3).contiguous()
    return (*sl_, lps, o, planes, sph, relaxed)


def equal_nan(a, b):
    import torch

    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def kernel_vs_plain(name, args, what):
    """Run kernel and plain version on the same CUDA inputs; require
    equality.  Returns the max abs difference (0 when equal)."""
    import torch

    from raytracer_tpu_torch.ops import kernels as K

    fn = {"ray_mask": (K.ray_mask, K.ray_mask_plain),
          "closest": (K.closest, K.closest_plain),
          "closest_shared": (K.closest, K.closest_plain),
          "shadow": (K.shadow, K.shadow_plain)}[name]
    out_k = fn[0](*args)
    out_p = fn[1](*args)
    torch.cuda.synchronize()
    if not isinstance(out_k, tuple):
        out_k, out_p = (out_k,), (out_p,)
    err = 0.0
    for xk, xp in zip(out_k, out_p):
        check(xk.shape == xp.shape and xk.dtype == xp.dtype,
              f"{name} {what}: output {xk.shape}/{xk.dtype} vs {xp.shape}/{xp.dtype}")
        if xk.dtype.is_floating_point:
            fin = torch.isfinite(xk) & torch.isfinite(xp)
            if bool(fin.any()):
                err = max(err, float((xk[fin] - xp[fin]).abs().max()))
            ok = equal_nan(xk, xp)
        else:
            ok = bool((xk == xp).all())
            err = max(err, float((xk.long() - xp.long()).abs().max()))
        check(ok, f"{name} {what}: kernel != plain "
                  f"({int((xk != xp).sum())} of {xk.numel()} differ)")
    return err


def check_scene_kernels(label, calls, gen, n_tiles=256):
    """Kernel == plain on a tile sample of every captured call."""
    import torch

    errs = {}
    for name, args in calls.items():
        if args is None:
            continue
        if name.startswith("ray_mask"):
            tiles = sample_tiles(args[0], n_tiles, gen)
            sl = slice_mask_args(args, tiles)
        elif name.startswith("closest"):
            tiles = sample_tiles(args[2] + args[5], n_tiles, gen)
            sl = slice_closest_args(args, tiles)
        else:
            tiles = sample_tiles((args[2] + args[5]).sum(0), n_tiles, gen)
            sl = slice_shadow_args(args, tiles)
        kname = "ray_mask" if name.startswith("ray_mask") else name
        err = kernel_vs_plain(kname, sl, f"{label} ({tiles.numel()} tiles)")
        extra = ""
        if not name.startswith("ray_mask"):
            # the other template instance: bfc for closest, relaxed for shadow
            flag = "bfc" if name.startswith("closest") else "relaxed"
            err = max(err, kernel_vs_plain(kname, sl[:-1] + (not sl[-1],),
                                           f"{label} {flag}={not sl[-1]}"))
            extra = f" (also {flag}={not sl[-1]})"
        errs[kname] = max(errs.get(kname, 0.0), err)
        if name.startswith("closest"):
            n_over = int((args[2][tiles] > 48).sum())
            errs["overflowed"] = errs.get("overflowed", 0) + n_over
            extra += f", overflowed lists: {n_over}"
        log(f"  {label} {name}: {tiles.numel()} tiles, kernel == plain{extra}")
        torch.cuda.synchronize()
    return errs


# ---------------------------------------------------------------------------
# bounds
# ---------------------------------------------------------------------------

def nbytes(*xs):
    import torch

    return sum(x.numel() * x.element_size() for x in xs
               if isinstance(x, torch.Tensor))


def work(name, args):
    """(ops, bytes) the call's data needs: pairs counted from the lists."""
    import torch

    if name == "ray_mask":
        act, box, bundle = args
        c = box.shape[1]
        ops = int((act != 0).sum()) * 128 * c * OPS["ray_mask"]
        out = act.shape[0] * c * 8
        return ops, nbytes(act, box[[0, 1, 2, 4, 5, 6]], bundle[:7]) + out
    if name.startswith("closest"):
        tw, tl, tc, sw, sl, sc, origin, dirs, tri, sph = args[:10]
        cs = sph.shape[1] // 128
        tri_v = int(tc.sum())
        sph_v = (int(((sc > 0).sum())) * cs if cs <= 8 else int(sc.sum()))
        per = OPS["tri_shared"] if origin.dim() == 1 else OPS["tri"]
        ops = (tri_v * per + sph_v * OPS["sph"]) * 128 * 128
        byt = (nbytes(tw, tl, tc, sw, sl, sc, origin, dirs)
               + min(tri.numel(), tri_v * 12 * 128) * 4
               + min(sph.numel(), sph_v * 4 * 128) * 4 + dirs.shape[0] * 8)
        return ops, byt
    tw, tl, tc, sw, sl, sc, lps, origin, planes, sph = args[:10]
    cs = sph.shape[1] // 128
    tri_v = int(tc.sum())
    sph_any = int(((sc > 0).any(0)).sum())
    sph_v = sph_any * cs * tc.shape[0] if cs <= 8 else int(sc.sum())
    ops = (tri_v * OPS["plane"] + sph_v * OPS["sph_shadow"]) * 128 * 128
    byt = (nbytes(tw, tl, tc, sw, sl, sc, lps, origin)
           + min(planes.numel(), tri_v * 16 * 128) * 4
           + min(sph.numel(), sph_v * 4 * 128) * 4 + origin.shape[0] * 4)
    return ops, byt


def profile_frame(frame, results):
    """One frame under torch.profiler: device time by kernel, and the
    device's idle share of the frame's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    frame()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies, memsets): the aten:: rows
    # of key_averages() repeat their kernels' device time
    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            acc = by_name.setdefault(ev.name, [0.0, 0])
            acc[0] += ev.time_range.elapsed_us() / 1e3
            acc[1] += 1
    if not by_name:
        log("  profiled frame: the profiler recorded no device events")
        return
    rows = [(ms, count, name) for name, (ms, count) in by_name.items()]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    mine = sum(r[0] for r in rows if any(
        k in r[2] for k in ("ray_mask_kernel", "closest_kernel", "shadow_kernel")))
    log(f"  profiled frame: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
        f"(idle share {1 - busy / wall_ms:.3f}), the three CUDA kernels "
        f"{mine:.3f} ms, other device work {busy - mine:.3f} ms")
    for ms, count, key in rows[:20]:
        log(f"    {ms:9.3f} ms  {count:5d}x  {key[:100]}")
    results["profile"] = {"wall_ms": wall_ms, "device_busy_ms": busy,
                          "kernels_ms": mine,
                          "top": [[ms, c, k[:100]] for ms, c, k in rows[:40]]}


def time_call(fn, args, n):
    import torch

    fn(*args)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn(*args)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def time_once(fn, args):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*args)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def render_scene(data, meta, cset, ssaa, device, res=None):
    import dataclasses

    from raytracer_tpu_torch.pipeline import render_one_camera

    cam = meta.cameras[0]
    if res is not None:
        cam = dataclasses.replace(cam, width=res, height=res)
    return render_one_camera(data, meta, cam, cset, ssaa=ssaa, device=device)


def build(scene_fn, device, **kw):
    from raytracer_tpu_torch.models.bvh import build_bvh
    from raytracer_tpu_torch.models.clusters import build_clusters

    data, meta = scene_fn(device=device, **kw)
    cset = build_clusters(data, meta, build_bvh(data, meta))
    return data, meta, cset


def run():
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "raytracer_tpu_torch")):
        print("FAIL: raytracer_tpu_torch/ not found beside chip_smoke.py",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import numpy as np

    from raytracer_tpu_torch import backend
    from raytracer_tpu_torch.ops import kernels as K
    from raytracer_tpu_torch.utils.synth import sphere_field, terrain_scene

    os.makedirs(OUT, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    results = {}

    # -- phase 1: set-up
    log("== phase 1: set-up")
    smi = smi_line()
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    t0 = time.perf_counter()
    backend.kernels()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"({backend.library_path()})")
    with open(os.path.join(backend.BUILD_DIR, "build.log")) as f:
        for line in f:
            if "registers" in line or line.startswith("=="):
                log("  " + line.rstrip())
    results["build_s"] = backend.build_seconds()

    # -- phase 2: entry scene through the CLI, CUDA vs CPU
    log("== phase 2: entry scene through the CLI")
    from raytracer_tpu_torch.render import main as cli_main
    from raytracer_tpu_torch.utils.ppm import read_ppm

    xml = os.path.join(REPO, "tests", "data", "entry_scene.xml")
    for ssaa in (1, 2):
        imgs = {}
        for d in ("cuda", "cpu"):
            out = os.path.join(OUT, f"entry_{d}_ssaa{ssaa}")
            cli_main([xml, "--ssaa", str(ssaa), "--device", d, "--out-dir", out])
            imgs[d] = read_ppm(os.path.join(out, "entry_scene.ppm"))
        compare_images(imgs["cuda"], imgs["cpu"], f"entry ssaa {ssaa} cuda vs cpu")
    from raytracer_tpu_torch.models.bvh import build_bvh
    from raytracer_tpu_torch.models.clusters import build_clusters
    from raytracer_tpu_torch.models.scene import load_scene
    from raytracer_tpu_torch.models.whitted import render_camera

    rad = {}
    for d in ("cuda", "cpu"):
        data, meta = load_scene(xml, device=d)
        cs = build_clusters(data, meta, build_bvh(data, meta))
        rad[d] = render_camera(data, meta, meta.cameras[0].scaled(2), cs, device=d)
    compare_radiance(rad["cuda"], rad["cpu"], "entry ssaa 2 radiance cuda vs cpu")

    # -- phase 3: full width
    log("== phase 3: full-width terrain (cells=126, res=1024, mirrors) at --ssaa 2")
    t0 = time.perf_counter()
    data, meta, cset = build(terrain_scene, dev, cells=126, res=1024,
                             mirror_stripes=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    pt, ct = cset.tri_dat.shape[1], cset.tri_dat.shape[1] // 128
    log(f"  scene: {meta.n_tris} triangles, {ct} clusters, Pt={pt}, "
        f"{meta.n_lights} lights, max_depth {meta.max_depth}; "
        f"BVH + clusters built in {build_s:.2f} s")
    cam = meta.cameras[0]
    rays = cam.width * 2 * cam.height * 2
    check(rays == 4_194_304, f"{rays} rays")
    render_scene(data, meta, cset, 2, dev)          # warm-up
    torch.cuda.synchronize()
    K.reset_launches()
    with Capture(K) as cap:
        img = render_scene(data, meta, cset, 2, dev)
    torch.cuda.synchronize()
    launches = dict(K.launches)
    log(f"  launches in one frame: {launches}")
    for name in ("ray_mask", "closest_shared", "closest", "shadow"):
        check(launches[name] > 0, f"{name} was not launched on the main path")
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_scene(data, meta, cset, 2, dev)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    frame_ms = statistics.median(times)
    log(f"  frame ms (5 warm runs): {[round(t, 3) for t in times]}")
    log(f"  median {frame_ms:.3f} ms/frame, {rays / frame_ms / 1e3:.3f} Mrays/s "
        f"(primary rays at ssaa 2)")
    col = render_camera(data, meta, cam.scaled(2), cset, device=dev)
    check(bool(torch.isfinite(col).all()), "full-width radiance has NaN/inf")
    bg = np.array([20, 30, 60], np.uint8)
    share = float((img != bg).any(-1).mean())
    log(f"  radiance finite; image {img.shape}, non-background share {share:.4f}")
    from raytracer_tpu_torch.utils.ppm import write_ppm

    write_ppm(os.path.join(OUT, "terrain_1024.ppm"), img)
    check(img.shape == (1024, 1024, 3) and share > 0.25,
          "the terrain covers less than a quarter of the frame")
    # the same scene through a 64x64 camera: wide tiles whose shortlists
    # overflow (the bitmask scan), checked against the CPU render
    small = {"cpu": render_scene(*build(terrain_scene, "cpu", cells=126,
                                        res=1024, mirror_stripes=True), 1,
                                 "cpu", res=64)}
    with Capture(K) as small_cap:
        small["cuda"] = render_scene(data, meta, cset, 1, dev, res=64)
    compare_images(small["cuda"], small["cpu"], "full-width terrain at 64x64, cuda vs cpu")
    profile_frame(lambda: render_scene(data, meta, cset, 2, dev), results)
    results["frame"] = {"ms": frame_ms, "runs_ms": times,
                        "mrays_per_s": rays / frame_ms / 1e3,
                        "launches": launches, "non_background": share}

    # -- phase 4: kernel == plain on the card
    log("== phase 4: kernels vs their plain versions on the card")
    gen = torch.Generator().manual_seed(0)
    errs = check_scene_kernels("terrain", cap.calls, gen)
    max_err = {n: errs.get(n, 0.0) for n in REPLACES}
    e = check_scene_kernels("terrain 64x64", small_cap.calls, gen)
    check(e.get("overflowed", 0) > 0, "no overflowed shortlist was checked")
    for n in REPLACES:
        max_err[n] = max(max_err[n], e.get(n, 0.0))
    for label, n_sph in (("sphere_field(20000)", 20000), ("sphere_field(600)", 600)):
        sd, sm, scs = build(sphere_field, dev, n_spheres=n_sph, res=512)
        log(f"  {label}: {sm.n_spheres} spheres, "
            f"{scs.sph_dat.shape[1] // 128} sphere clusters, {sm.n_lights} light(s)")
        with Capture(K) as scap:
            simg = render_scene(sd, sm, scs, 1, dev)
        check((simg != np.array([15, 20, 40], np.uint8)).any(-1).mean() > 0.1,
              f"{label}: image is background")
        compare_images(
            render_scene(sd, sm, scs, 2, dev, res=64),
            render_scene(*build(sphere_field, "cpu", n_spheres=n_sph, res=512),
                         2, "cpu", res=64),
            f"{label} at 64x64 ssaa 2, cuda vs cpu")
        e = check_scene_kernels(label, scap.calls, gen)
        for n in REPLACES:
            max_err[n] = max(max_err[n], e.get(n, 0.0))
        if n_sph == 20000:
            one_light = scap.calls["shadow"]

    # -- phase 5: timings at the phase-3 shapes
    log("== phase 5: kernel timings at the full-width shapes")
    fns = {"ray_mask": (K.ray_mask, K.ray_mask_plain),
           "closest_shared": (K.closest, K.closest_plain),
           "closest": (K.closest, K.closest_plain),
           "shadow": (K.shadow, K.shadow_plain)}
    rows = []
    for name in ("ray_mask", "closest_shared", "closest", "shadow"):
        args = cap.calls[name]
        ms = time_call(fns[name][0], args, 10)
        plain_ms = time_once(fns[name][1], args)
        ops, byt = work(name, args)
        t_ops, t_bytes = ops / PEAK_FP32 * 1e3, byt / PEAK_BYTES * 1e3
        bound_ms = max(t_ops, t_bytes)
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max_err.get(name, 0.0), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
        })
        log(f"  {name}: {ms:.4f} ms/launch, {launches[name]} launches/frame, "
            f"bound {bound_ms:.4f} ms ({rows[-1]['bound_by']}: {ops:.3e} ops, "
            f"{byt:.3e} bytes), plain {plain_ms:.2f} ms, "
            f"{bound_ms / ms:.3f} of the bound")
    # the single-light call shape (TPU row 5) is not on the 2-light main
    # path: timed on the sphere field's shadow wave, reported in the log
    ms = time_call(K.shadow, one_light, 10)
    ops, byt = work("shadow", one_light)
    bound_ms = max(ops / PEAK_FP32, byt / PEAK_BYTES) * 1e3
    log(f"  shadow, 1 light (sphere_field(20000) at 512x512, walk + early "
        f"exit): {ms:.4f} ms/launch, bound {bound_ms:.4f} ms (list-counted "
        f"visits, an upper bound under the early exit), plain "
        f"{time_once(K.shadow_plain, one_light):.2f} ms")
    log("  library_ms: null for every kernel; no single PyTorch call computes "
        "a slab mask over cluster shortlists, a shortlist closest hit or a "
        "plane-table shadow test")
    results["kernels"] = rows
    results["card"] = smi
    with open(os.path.join(OUT, "results.json"), "w") as f:
        json.dump(results, f, indent=1)

    log(f"card: {smi_line()}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    try:
        return run()
    except Failure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
