#!/usr/bin/env python3
"""A/B of the PyTorch port's CUDA kernels on one card.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 experiments/torch_kernel_ab.py --base DIR[,DIR...] [--variants auto,4x4,16x4]
        [--kernels NAME,...] [--no-frames] [--probes]

Each DIR holds another version of ``raytracer_tpu_torch/csrc`` (for example
the parent commit's, unpacked with ``git archive``).  The script builds one
kernel library from each DIR ("base" for the first, the directory's name
for the others) and one for each variant of this
checkout's csrc, with ``backend.compile_library``: ``auto`` is csrc as the
package builds it (the warps per block chosen per launch); ``GxS`` is a
copy of csrc, under the build directory, whose ``common.cuh`` gives every
launch G warps per block and splits each visit's lanes S ways; ``mG`` (or
``mGxB``) a copy whose ``ray_mask.cu`` gives the hierarchical mask blocks
of at most G chunks (aiming at B blocks a SM).  Then it:

1. captures the calls with the most work of each kernel (closest hit in
   both call shapes, any-hit, the flat and the hierarchical mask, shadow)
   in the full-width terrain frame, the big terrain frame (whose flat
   masks are the supercluster passes) and the mid terrain frame (the
   single-light shadow call): the scenes of ``chip_smoke.py`` phases 3
   and 3b, rendered through this checkout's library;
2. on each captured call: every library's result equals the plain
   PyTorch version's, bit for bit; its ms per launch (CUDA events over 10
   launches, the libraries timed in the order A B C C B A and averaged);
   the call's bound (``chip_smoke.work``) and the tiles' visit counts;
3. the full-width frame's median wall ms over 3 frames and the big
   frame's device busy ms and each kernel's device ms (one profiled
   frame) with each library, in the same A B C C B A order.

``--kernels`` keeps step 2 to the kernels named (closest_shared, closest,
any, ray_mask, ray_mask_hier, shadow); ``--no-frames`` leaves out step 3;
``--probes`` adds to step 2 the hierarchical mask's calls with every
coarse bit 0 (the dead chunks' writes alone) and with every bit 1.

Prints a line per measurement and writes ``smoke_out/kernel_ab.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


TIMED = ("closest_shared", "closest", "any", "ray_mask", "ray_mask_hier",
         "shadow")


def variant_csrc(label, out_dir):
    """This checkout's csrc for variant ``label`` (see the module note)."""
    import re
    import shutil

    csrc = os.path.join(REPO, "raytracer_tpu_torch", "csrc")
    if label == "auto":
        return csrc
    dst = os.path.join(out_dir, f"src_{label}")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(csrc, dst)
    if label.startswith("m"):
        path = os.path.join(dst, "ray_mask.cu")
        names = ("RT_HIER_GROUP_MAX", "RT_HIER_BLOCKS_PER_SM")
        subs = [(rf"#define {n} \d+\n", f"#define {n} {v}\n")
                for n, v in zip(names, label[1:].split("x"))]
    else:
        # every launch narrow (no launch has <= 0 tiles per SM), G warps wide
        path = os.path.join(dst, "common.cuh")
        g, sp = label.split("x")
        subs = [(r"#define RT_LANE_SPLIT 4\n", f"#define RT_LANE_SPLIT {sp}\n"),
                (r"#define RT_NARROW_WARPS 4\n", f"#define RT_NARROW_WARPS {g}\n"),
                (r"#define RT_WIDE_TILES_PER_SM 16\n",
                 "#define RT_WIDE_TILES_PER_SM 0\n")]
    with open(path) as f:
        text = f.read()
    for old, new in subs:
        text, n = re.subn(old, new, text)
        cs.check(n == 1, f"{label}: {old!r} not once in {os.path.basename(path)}")
    with open(path, "w") as f:
        f.write(text)
    return dst


def build_libs(variants, out_dir):
    """{label: library path} for each (label, csrc dir), the libraries
    built side by side; logs each build's registers and spills."""
    from concurrent.futures import ThreadPoolExecutor

    from raytracer_tpu_torch import backend

    os.makedirs(out_dir, exist_ok=True)
    paths = {label: os.path.join(out_dir, f"lib_{label}.so") for label, _ in variants}
    logs = {label: os.path.join(out_dir, f"{label}.log") for label, _ in variants}
    with ThreadPoolExecutor(len(variants)) as pool:
        for fut in [pool.submit(backend.compile_library, csrc, paths[label],
                                logs[label]) for label, csrc in variants]:
            fut.result()
    for label in paths:
        with open(logs[label]) as f:
            for line in f:
                if "registers" in line or "stack frame" in line:
                    cs.log(f"  {label}: {line.strip()}")
    return paths, logs


def probes(name, args, on):
    """(label suffix, call) pairs to time for a captured call: the call,
    and with ``on`` for the hierarchical mask the same call with every
    coarse bit 0 (the dead-chunk writes alone) and with every bit 1 (every
    chunk of an active tile tested)."""
    out = [("", args)]
    if on and name == "ray_mask_hier":
        act, sup, box, bundle = args
        out += [(" (every coarse bit 0)", (act, sup * 0, box, bundle)),
                (" (every coarse bit 1)", (act, sup * 0 + 1, box, bundle))]
    return out


def time_libs(out, libs, order, scene, label, name, args):
    """Check every library's result against the plain version on the call
    ``args`` of kernel ``name``, time each in the order ``order``, and log
    and keep the row under ``label``."""
    import torch

    from raytracer_tpu_torch import backend

    wrapper, plain = cs.kernel_pairs()[name]
    ref = plain(*args)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for lib in libs:
        backend.load_library(libs[lib])
        got = wrapper(*args)
        got = got if isinstance(got, tuple) else (got,)
        torch.cuda.synchronize()
        for x, y in zip(got, ref):
            cs.check(cs.equal_nan(x, y) if x.dtype.is_floating_point
                     else bool((x == y).all()), f"{scene} {label}: {lib} != plain")
    ms = {lib: [] for lib in libs}
    for lib in order:
        backend.load_library(libs[lib])
        ms[lib].append(cs.time_call(wrapper, args, 10))
    ops, byt = cs.work(name, args)
    bound = max(ops / cs.PEAK_FP32, byt / cs.PEAK_BYTES) * 1e3
    row = {"scene": scene, "name": label, "bound_ms": bound,
           "visits": cs.call_spread(name, args),
           "ms": {k: statistics.mean(v) for k, v in ms.items()}, "runs_ms": ms}
    out["calls"].append(row)
    cs.log(f"  {scene} {label}: all equal to plain; bound {bound:.4f} ms; "
           f"visits {row['visits']}")
    for k, v in ms.items():
        cs.log(f"    {k:6s} {statistics.mean(v):.4f} ms/launch "
               f"(runs {[round(x, 4) for x in v]}), "
               f"{bound / statistics.mean(v):.3f} of the bound")


def device_busy_ms(frame):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    frame()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        frame()
        torch.cuda.synchronize()
    busy, kern = 0.0, {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            ms = ev.time_range.elapsed_us() / 1e3
            busy += ms
            name = cs.kernel_of(ev.name)
            if name is not None:
                kern[name] = kern.get(name, 0.0) + ms
    return busy, kern


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True,
                    help="other csrc directories, comma-separated")
    ap.add_argument("--variants", default="auto",
                    help="auto, or GxS: G warps a block, each visit's lanes "
                         "split S ways, or mG[xB]: the hierarchical mask "
                         "with G chunks a block at most (B blocks a SM)")
    ap.add_argument("--kernels", default=",".join(TIMED),
                    help="the kernels whose captured calls are timed")
    ap.add_argument("--no-frames", action="store_true",
                    help="time no whole frames")
    ap.add_argument("--probes", action="store_true",
                    help="time the hierarchical mask's calls also with every "
                         "coarse bit 0 and with every bit 1")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    from raytracer_tpu_torch import backend
    from raytracer_tpu_torch.ops import kernels as K
    from raytracer_tpu_torch.utils.synth import terrain_scene

    card = cs.smi_line()
    cs.log(f"card: {card}")
    out_dir = os.path.join(backend.BUILD_DIR, "ab")
    bases = a.base.split(",")
    variants = ([("base", bases[0])]
                + [(os.path.basename(os.path.normpath(d)), d) for d in bases[1:]]
                + [(v, variant_csrc(v, out_dir)) for v in a.variants.split(",")])
    labels = [label for label, _ in variants]
    cs.check(len(set(labels)) == len(labels),
             f"two trees or variants share a label: {labels}")
    t0 = time.perf_counter()
    libs, logs = build_libs(variants, out_dir)
    cs.log(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s")
    out = {"card": card, "ptxas": {label: cs.ptxas_report(logs[label])
                                   for label in libs if label != "base"},
           "calls": [], "frames": {}}
    order = list(libs) + list(libs)[::-1]
    dev = torch.device("cuda")

    for scene, kw in (("full", dict(cells=126, res=1024, mirror_stripes=True)),
                      ("big", dict(cells=512, res=1024, mirror_stripes=True)),
                      ("mid", dict(cells=200, res=512, mirror_stripes=True))):
        backend.load_library(libs[list(libs)[-1]])
        data, meta, cset = cs.build(terrain_scene, dev, **kw)
        cs.render_scene(data, meta, cset, 2, dev)
        with cs.Capture(K) as cap:
            cs.render_scene(data, meta, cset, 2, dev)
        torch.cuda.synchronize()
        for name in a.kernels.split(","):
            args = cs.frame_call(cap, name)
            if args is None:
                continue
            for what, args in probes(name, args, a.probes):
                time_libs(out, libs, order, scene, name + what, name, args)
        del cap
        if scene == "mid" or a.no_frames:      # kernel calls only
            del data, cset
            continue
        frame = lambda: cs.render_scene(data, meta, cset, 2, dev)  # noqa: E731
        res = {label: [] for label in libs}
        for label in order:
            backend.load_library(libs[label])
            if scene == "full":
                frame()
                runs = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    frame()
                    torch.cuda.synchronize()
                    runs.append((time.perf_counter() - t0) * 1e3)
                res[label].append({"wall_ms": statistics.median(runs), "runs": runs})
            else:
                busy, kern = device_busy_ms(frame)
                res[label].append({"device_busy_ms": busy, "kernels_ms": kern})
            cs.log(f"  {scene} frame with {label}: {res[label][-1]}")
        out["frames"][scene] = res
        del data, cset
        torch.cuda.empty_cache()
    os.makedirs(cs.OUT, exist_ok=True)
    with open(os.path.join(cs.OUT, "kernel_ab.json"), "w") as f:
        json.dump(out, f, indent=1)
    cs.log(f"card: {cs.smi_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
