#!/usr/bin/env python3
"""GPU smoke test of raytracer_tpu_torch, the PyTorch/CUDA port.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the CUDA kernels from raytracer_tpu_torch/csrc (nvcc, sm_90a),
then:

1. set-up: build time, the card's name and power limit, from the build
   log (``ptxas -v``) the registers, spills and static shared memory of
   each kernel instance with the blocks per SM its registers allow, and
   from ``cuobjdump -sass`` each instance's NaN-propagating FMNMX count
   (the masks and the shadow kernel must have some) and its instructions
   (the threefry draw's bound);
2. entry scene: tests/data/entry_scene.xml through the CLI's ``main`` on
   CUDA at --ssaa 1 and 2, against the same runs with --device cpu (the
   plain PyTorch versions of the kernels); then at --ssaa 2 with --format
   png, --format exr, --tone aces, a --chunk that streams 8 bands, and
   --ssaa-mode jitter and adaptive under one --seed (the threefry draw
   kernel launched), each CUDA run's
   launch counts (the single light takes the 1-light shadow call) and its
   image against the CPU's through the diff CLI
   (``raytracer_tpu_torch.compare``); --accel-cache twice (the second run
   must load the cache); each --engine (brute, bvh, cluster, auto) on CUDA
   (through captured programs, every engine) and on the CPU (0 differing
   channels; brute and bvh launch no kernel, and meet the image bar
   against cluster); the train CLI on CUDA from a
   PNG target (--steps 3 with --checkpoint and --out, then a resume for 2
   steps: the losses fall, and the steps launch the flat mask, the
   per-ray-origin closest hit and the 1-light shadow, no shared-origin
   closest hit);
3. full width: ``terrain_scene(cells=126, res=1024, mirror_stripes=True)``
   (31,752 triangles, 2 lights, mirrors) rendered at --ssaa 2 (4,194,304
   rays, one band) through ``render_one_camera``: build time, warm
   ms/frame, Mrays/s, each kernel's launches in one frame (all > 0), NaN
   check and non-background share, the process's CPU time and involuntary
   context switches over each timed frame, one frame under torch.profiler
   (device time by kernel, idle share; on the host: PyTorch ops, kernel
   launches, the ops that wait for the device, sorts, CUDA runtime calls);
   the same scene through a 64x64 camera against the CPU render;
3b. big scene: ``terrain_scene(cells=512, res=1024, mirror_stripes=True)``
   (524,288 triangles, 4,096 clusters: plane tables over the 8 MB budget,
   so every shadow wave takes the any-hit kernel, and the hierarchical
   mask) at --ssaa 2 through ``render_one_camera`` (4,194,304 rays in 32
   bands of 131,072): build time, warm ms/frame, launches per frame
   (ray_mask_hier and any > 0, shadow 0), peak device memory, NaN check,
   non-background share, one profiled frame, and a 64x64 camera against
   the CPU render; then ``terrain_scene(cells=200, res=512)`` (80,000
   triangles: one shadow launch per light, the hierarchical mask) once;
4. each kernel against its plain version ON THE CARD, on the real inputs
   captured from the phase-3 and 3b waves (and from two sphere fields: the
   sphere walk with its early exit and the single-light shadow, and the
   dense sphere rows, each also rendered at 64x64 on CUDA and on the CPU
   and compared, and rendered once more with the plane budget at 0 so its
   shadow waves reach the any-hit kernel through ``cluster_any``; the
   64x64 terrain camera gives tiles whose shortlists overflow into the
   bitmask scan; the exact-tie case of ``tests/torch_tie_case.py``; the
   NaN-poison case of ``tests/torch_poison_case.py`` with 1 and 2 lights),
   on a sample of >= 256 tiles, with the other template instances too (bfc
   for closest, relaxed for shadow, both for any) and, for the closest,
   any-hit and shadow kernels, the sample repeated past the launch size
   that takes 4-warp blocks; the flat mask also at column counts that take
   each of its instances: results must be EQUAL (the kernels round op for
   op like eager PyTorch, -fmad=false); the hierarchical mask also equals
   the flat one, on the whole big and mid terrain calls too, at the launch
   sizes on each side of every change of its chunks per block, and on the
   case of ``tests/torch_hier_case.py``;
5. timings of each kernel at the busiest call of each frame that runs it
   (the full-width frame and the big terrain's busiest chunk, whose flat
   mask is the supercluster pass; the single-light shadow call at the
   80,000-triangle terrain's, and its hierarchical mask call) with its
   bound from the work the call's data needs (the any-hit kernels' pairs
   counted up to each ray's first hit), the spread of visits per tile (of
   live chunks per active tile for the hierarchical mask), launches timed
   on the device behind a spin;
   each kernel's device ms and launches in each profiled frame, and each
   frame's ranking of the kernels by the device time they lose against
   their bounds; 5b the forward bounce epilogue and 5c the shortlist
   compaction (``csrc/compact.cu``) at the busiest calls of the horse31k
   (and, for 5c, terrain524k) benchmark frames: equal to the plain version,
   timed against the byte bound and (5c) the plain version's torch.sort
   route on the card, launches and device ms in a replayed frame; 5d the
   shared-eye interval tile mask (``csrc/tile_mask.cu``) at the terrain524k
   band's call (1,024 tiles x 4,096 columns) and the horse31k frame's
   (32,400 x 247): equal to the plain version, timed against its bound and
   the plain version on the card, launches and device ms a replayed frame;
6. the render modes beyond one band, on the full-width terrain through
   ``render_one_camera``: streamed at --ssaa 4 parity (16,777,216 rays in
   4 bands), --ssaa 2 jitter and adaptive (4 base samples a pixel, 12
   more for 12.5% of the pixel blocks), each with one frame's launch
   counts, bands, activity compactions and jitter draws (timed on the
   card) and its kernel inputs captured and held against the plain
   versions as in phase 4 (adaptive's refinement waves, and the waves
   after a compaction, apart from the base wave), then warm ms/frame
   (median of 3) with their peak device memory, Mrays/s of primary rays
   (samples, for adaptive), one profiled frame (device busy, idle share);
   each mode at 64x64 against the CPU (the jitter drawn on CUDA, equal
   bit for bit to the CPU's draw, and replayed on the CPU); then the big
   terrain through a 512x512 camera at --ssaa 2 jitter (8 bands at the
   131,072-ray cap: both masks, the closest shapes and any-hit launched,
   no shadow kernel) with its kernel inputs captured and checked, once
   more for its peak memory, and at 64x64 against the CPU; the jitter and
   adaptive frames must launch the threefry draw kernel;
6b. the threefry draw kernel (csrc/threefry.cu), its key read from device
   memory, against its plain version on the same key tensor on the card,
   bit for bit, at the full-width band shape (2048, 2048, 2) and the
   adaptive frame's base and round shapes, against the host-key call on
   the same key and against the first and last 8 floats of JAX's own
   draws (``JAX_DRAWS``); the band draw timed on the device beside its
   plain version and its bound, the card's issue ceiling over phase 1's
   SASS instructions at the maximum SM clock ``nvidia-smi`` reports (the
   clock it reads while the kernel runs logged beside it);
6c. the full-width terrain on treelet clusters (``build_clusters(...,
   treelet=True)``) at --ssaa 2: one frame's launches and kernel calls
   against the plain versions, 3 timed frames, and at 64x64 against the
   CPU;
7. training at full width: ``make_train_step`` (cluster engine, fields
   mat_diffuse and light_int, Adam at lr 3e-2) on the full-width terrain
   over its 1024x1024 camera's 1,048,576 eye rays (raster order) each
   step, the target the forward radiance of the true scene, the start
   with mat_diffuse x 0.5 and light_int x 0.7: 5 steps on the replayed
   route (the first eager, then captured), the loss falling and every
   gradient finite; the first step's launch counts (the flat mask, the
   per-ray-origin closest hit and the n-light shadow, no shared-origin
   closest hit); a sixth step eager with the same launches, its kernel
   calls each held against its plain version; s/step (median of steps
   2-5, replayed), rays/s, peak device memory, one profiled step (device
   busy, idle share); one step with vertices trained too, its gradients
   finite;
7b. one training step on CUDA against the CPU, for brute, bvh and
   cluster, on the full-width terrain through a 64x64 camera and on the
   entry scene: the loss to rtol 1e-5, each field's gradient within 1e-3
   of its max |g|;
7c. ``examples/inverse_rendering_torch.py`` on the entry scene: 200 Adam
   steps on the card, the loss falling below a tenth of its start;
8. the mesh, processes and the server (``parallel``, ``serve``):
   8a. the full-width terrain at --ssaa 2 through render_one_camera on a
   2-shard mesh of cuda:0 (two logical shards of 2,097,152 rays), its
   band replayed as one program: equal bit for bit to phase 3's image and
   to the same frame eager (equal launches; its kernel calls held against
   the plain versions), every kernel of phase 3 launched, warm ms/frame
   (median of 3) and peak, eager against replayed as in phase 9; the
   terrain and the entry scene at 64x64 on it against the CPU's 2-shard
   render in parity and jitter mode; 128x150, whose last band takes
   virtual rows, eager and replayed, bit for bit against one device;
   8b. two processes (``chip_smoke.py --worker RANK STORE``), gloo over a
   file store in smoke_out/, both on cuda:0: each renders its half of the
   full-width frame, replayed, which must equal phase 3's image and the
   eager frame on both ranks, with the frame's ms and its gather's ms and
   eager against replayed as in phase 9; 3 sharded training steps on a
   64x64 camera, the loss within 1e-5 of the one-process step; the
   two-step training program (the all-reduce between its graphs) against
   the eager multi-process step: 3 steps bit for bit at 64x64 under
   deterministic algorithms, phase 9's spread bar on phase 7's problem
   (524,288 rays a rank), 5 timed steps (median of steps 2-5) and eager
   against replayed; the parameters equal on both ranks;
   8c. phase 7's training on a 2-shard mesh (one process: replayed): 5
   steps, the loss falling, every gradient finite, step 1 against phase
   7's loss (rtol 1e-5) and a one-device step's gradients and parameters
   (1e-3 of each field's max), an eager step's kernel calls against the
   plain versions, s/step;
   8d. ``python -m raytracer_tpu_torch.serve`` on stdin: ping, the entry
   scene equal to phase 2's CLI image, the full-width terrain written to
   a scene XML and rendered at --ssaa 2 twice (the second from the cache)
   equal to render_one_camera on the loaded XML, a bad ssaa_mode answered
   and survived, shutdown (exit 0), each request's render_s and Mrays/s;
   over TCP (--port 0) a render, a client dropping mid-request, a
   reconnect, ping and shutdown; the served terrain frame in process with
   its launches and kernel calls against the plain versions;
   8e. measure_scaling over 1 and 2 logical shards of the card (the split,
   not a scaling result), replayed: its second run captures nothing;
9. the compiled programs (``models.programs``: the cluster engine's
   frames, the adaptive frame and the training step as captured CUDA
   graphs, the default on the card) against the same bodies run eagerly
   (``whitted.eager()``) on the full-width frame, streamed --ssaa 4, the
   jitter frame (one band, and 4 bands: 4 draws inside the replayed band
   program, each under the key written before its replay), the adaptive
   frame (and through a 64x64 camera; each wave's draw inside its
   program), the big terrain and a warm served
   terrain request: 0 differing pixels and equal launches (or the run
   fails), ms/frame (median of 5 warm frames of each, in turns), device
   busy ms and idle share of one profiled frame of each, top-level host
   ops per frame, the first graph call's captures, their ms and the graph
   pool's bytes, each frame's peak allocated outside the pool, the
   threefry draw's launches, device events and ms in each replayed jitter
   and adaptive frame's profile (its ms only when every launch is
   listed); the threefry draw's device events in 5 profiled jitter frames
   and 5 profiled draws alone, each with no spin first and with a
   2**26-cycle spin; the
   training step: at full width (phase 7's problem) 5 steps from one
   start twice eager and once replayed, step 1's loss equal bit for bit;
   then each step replayed from the eager run's state before it, its loss
   and each field's gradient within ``SPREAD_FACTOR`` times the spread of
   1 + ``SPREAD_RUNS`` eager steps from that state (both printed), its
   params and Adam state equal bit for bit to eager Adam on its gradients;
   on a 64x64 camera under ``torch.use_deterministic_algorithms(True)`` 3
   steps eager and replayed equal bit for bit (a capture that fails there
   fails the run); phase 7's step eager against replayed as the frames
   are (equal launches, ms, device busy, idle, host ops, captures, pool);
10. brute and BVH programs, eager against replayed, as phase 9 compares
   (median of ``ENGINE_RUNS``; the BVH modes' eager frame and the 64x64
   eager step timed once and not profiled; also the host's flag reads and
   the BVH walk's iterations, equal): the full-width terrain's BVH (octant
   threads) through a ``BVH_SIDE`` camera's radiance, then at
   ``MODES_SIDE`` streamed --ssaa 4, jitter, adaptive, a 2-shard mesh band
   and a warm served --engine bvh request; brute on the 64-sphere mirror
   field at 1024x1024 --ssaa 2 and on the entry scene; each engine's
   training step at 64x64 under deterministic algorithms (3 steps bit for
   bit), at ``TRAIN_SIDE`` within the spread bar (``ENGINE_SPREAD_STEPS``
   steps), and eager against replayed at both sizes;

Phases 3, 3b, 6, 6c, 7, 8a-8d count launches on the replayed programs
(a replay adds the launch counts its capture recorded) and record kernel
calls in the same frame, or one more step, run eagerly, which must give
the same image (a frame) and launches: a replayed graph calls no
wrapper.

and prints the kernels' JSON line, then ``{"ok": true, "device": ...}``
as its last line.  Any failure exits non-zero without that line.  Images
and a results.json land in smoke_out/ (git-ignored).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import resource
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
# the FP32 issue rate (132 SMs x 128 lanes x 1980 MHz): the rate of one
# float operation a lane a clock, with no FMA to count twice
PEAK_ISSUE = 33.454e12

# float operations per (ray, primitive-or-box) pair, counted from the
# kernel sources: csrc/ray_mask.cu (6 mul, 6 sub, 4 min/max with the near
# and far planes named by the ray's octant, 3 compares, 1 min; the
# hierarchical kernel the same on the chunks it tests),
# csrc/closest.cu (triangle: 15 mul/add for nd and the two
# edge-direction dots, 9 for the origin dots (3 per lane with a shared
# origin, counted per pair as 0), 1 sub, 1 div, 4 for beta/gamma, 2 for
# alpha, 4 compares, 2 for the winner; sphere: 3 sub, 6 dot, 1 mul, 6
# for c_q, 4 for disc, 1 max, 1 sqrt, 3 for t1, 1 div, 5 compares, 2 for
# the winner), csrc/shadow.cu (4 planes x 6, 3 min, 2 compares; sphere as
# in closest without the winner), csrc/any.cu (triangle as in closest
# with t < t_max and the OR in place of the winner; sphere as in shadow)
OPS = {"ray_mask": 20, "tri": 43, "tri_shared": 34, "sph": 33,
       "plane": 29, "sph_shadow": 31, "tri_any": 43}
# integer and float operations per element of the threefry draw, counted
# from csrc/threefry.cu: 20 rounds of add, rotate (one funnel shift) and
# xor, 5 key injections of 3 adds, 3 for the counter words, 2 for ks2, 8
# for the bits-to-float steps.  Its older bound held them against the FP32
# rate, which counts an FMA as two operations; phase 6b's bound is the
# issue ceiling over the kernel's SASS instructions, this one printed
# beside it
OPS_THREEFRY = 88
# float operations of the shared-eye interval tile mask (csrc/tile_mask.cu),
# counted from the source on its four-product path: per (tile, column) pair
# and axis 2 subtracts, 4 multiplies, 6 min/max (36), 4 for the axis
# reductions, 2 compares (42; 1 more with a t window); per active ray 12
# min/max for its tile's bounds (1 more).  Left out, so the bound stays
# below the work: the eight-product path's 42 more a pair where a bound is
# not finite (NaN boxes)
OPS_TILE_MASK = {"pair": 42, "ray": 12}

KERNELS = ("ray_mask", "ray_mask_hier", "closest_shared", "closest",
           "shadow", "any")
# the JAX package's jitter draw (jax.random.uniform, an XLA kernel, not
# Pallas), timed and checked in phase 6b
REPLACES = {
    "ray_mask": "raytracer_tpu/ops/cluster_trace.py:305",
    "ray_mask_hier": "raytracer_tpu/ops/cluster_trace.py:242",
    "closest_shared": "raytracer_tpu/ops/cluster_trace.py:720",
    "closest": "raytracer_tpu/ops/cluster_trace.py:720",
    "shadow": "raytracer_tpu/ops/cluster_trace.py:1135",
    "any": "raytracer_tpu/ops/cluster_trace.py:837",
    "threefry": "raytracer_tpu/models/whitted.py:369",
    "hit_record": "raytracer_tpu/ops/cluster_trace.py:1603 (XLA's fusion "
                  "after the kernel) and raytracer_tpu/ops/shade.py",
    "shade_bounce": "raytracer_tpu/ops/shade.py shade_local, "
                    "reflection_rays; raytracer_tpu/models/whitted.py _shade",
    "compact": "raytracer_tpu/ops/cluster_trace.py _compact (lax.top_k and "
               "the bit packing)",
    "tile_mask": "raytracer_tpu/ops/cluster_trace.py tile_cluster_mask (XLA "
                 "glue, no Pallas kernel)",
}
SOURCES = {
    "ray_mask": "raytracer_tpu_torch/csrc/ray_mask.cu",
    "ray_mask_hier": "raytracer_tpu_torch/csrc/ray_mask.cu",
    "closest_shared": "raytracer_tpu_torch/csrc/closest.cu",
    "closest": "raytracer_tpu_torch/csrc/closest.cu",
    "shadow": "raytracer_tpu_torch/csrc/shadow.cu",
    "any": "raytracer_tpu_torch/csrc/any.cu",
    "threefry": "raytracer_tpu_torch/csrc/threefry.cu",
    "hit_record": "raytracer_tpu_torch/csrc/shade.cu",
    "shade_bounce": "raytracer_tpu_torch/csrc/shade.cu",
    "compact": "raytracer_tpu_torch/csrc/compact.cu",
    "tile_mask": "raytracer_tpu_torch/csrc/tile_mask.cu",
}

# float operations of the forward bounce epilogue (csrc/shade.cu), counted
# from the source, a library call (sqrtf, acosf, powf) as one: hit_record
# 17 a ray (point, offset, |d|^2 of the sphere test), 30 a (ray, small
# sphere) pair (the closest kernel's sphere test and the merge), 18 a
# (ray, light) pair (the relevance test); shade_bounce 42 a ray that hits
# (ambient, the two normalizations, color, reflection, throughput), 62 a
# (hit, light) pair (the relevance test again, the segment, Blinn-Phong,
# the sum).  Left out, so the bound stays below the work: a sphere hit's
# normal (15) and the segment test of a relevant pair against each small
# sphere (29)
OPS_EPILOGUE = {"ray": 17, "sphere_pair": 30, "light": 18, "hit": 42,
                "hit_light": 62}

# jax.random.uniform(key, shape, float32, -0.5, 0.5) of JAX 0.9.0
# (threefry2x32, partitionable), as the JAX package keys it (the port's
# draw_jitter keys): the bits of its first and last 8 floats.  (seed,
# key, shape): the full-width SSAA 2 band of seed 3, and the full-width
# adaptive frame's base wave and rounds 0 and 1 of seed 0.
JAX_DRAWS = [
    (3, ("band", 0), (2048, 2048, 2),
     [0xbefb8c48, 0xbee97a58, 0xbe40f300, 0xbeaa1db4, 0x3d9a7a40, 0x3ebc13e0,
      0x3e8c5db4, 0xbef76ad8],
     [0x3eea1ec8, 0x3eb99a64, 0xbdbce210, 0xbe757e28, 0xbea14f2c, 0xbec7457c,
      0xbe8bd0f8, 0xbe120128]),
    (0, ("base", 0), (8192, 4, 128, 2),
     [0x3eaf43cc, 0xbea29f44, 0xbe8baf50, 0xbec23040, 0xbe9dcaa0, 0x3e6357e8,
      0x3e87e87c, 0xbeb1e638],
     [0xbe18b450, 0xbda65270, 0x3d9606b0, 0xbedc7d48, 0x3dc0bcc0, 0xbea61fd8,
      0x3e2cea50, 0x3e804f44]),
    (0, ("round", 0), (1024, 12, 128, 2),
     [0xbefc43fc, 0xbef54dc0, 0x3da6c2f0, 0xbe0d7a58, 0xbe8dce00, 0xbec2eca4,
      0xbebfc678, 0x3def4490],
     [0x3e58b010, 0xbce58280, 0x3e311948, 0xbd255860, 0xbef946c0, 0xbe938c48,
      0x3ebc26f8, 0xbd0e78e0]),
    (0, ("round", 1), (1024, 6, 128, 2),
     [0xbed17df4, 0xbe0d1958, 0x3df90d10, 0xbeaee2bc, 0xbcfd0500, 0xbea326cc,
      0x3dd76270, 0x3eee2360],
     [0x3d6d2980, 0x3eb9bca8, 0xbe4a4d48, 0x3eca8430, 0x3eecc908, 0x3e88394c,
      0x3d13d540, 0xbea0ded0]),
]


class Failure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise Failure(msg)


_T0 = time.perf_counter()


def log(*a):
    """Print a line; a phase heading ("== ...") gets the seconds since the
    script started."""
    if a and str(a[0]).startswith("=="):
        a = (*a, f"[{time.perf_counter() - _T0:.1f} s]")
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
    """Wraps the kernel wrappers of ops.kernels and keeps the inputs of one
    call of each shape, the one with the most work (a chunked frame's first
    chunks may be all sky): shared-origin closest (bounce 0), per-ray-origin
    closest (bounce >= 1) with the flat mask that precedes it, the flat
    mask ("ray_mask_first"), shadow, hierarchical mask and any-hit.  While
    ``tag`` is set (``tagged_waves``), calls are kept apart under
    ``name + tag``."""

    def __init__(self, kernels):
        self.k = kernels
        self.orig = {n: getattr(kernels, n) for n in (
            "ray_mask", "ray_mask_hier", "closest", "shadow", "any_hit")}
        self.calls = {}
        self.score = {}
        self.last_mask = None
        self.tag = ""

    def keep(self, name, a, score):
        """Keep a copy of call ``a`` under ``name`` (and the tag) if score()
        is the highest yet: a wavefront's static buffers, some of the
        call's inputs, are rewritten by its later bounces."""
        name += self.tag
        sc = score()
        if sc > self.score.get(name, -1):
            self.calls[name] = tuple(
                x.clone() if hasattr(x, "clone") else x for x in a)
            self.score[name] = sc
            return True
        return False

    def __enter__(self):
        k, orig = self.k, self.orig

        def lists(a):
            return lambda: int(a[2].sum()) + int(a[5].sum())

        def ray_mask(*a):
            self.last_mask = a
            self.keep("ray_mask_first", a,
                      lambda: int((a[0] != 0).sum()) * a[1].shape[1])
            return orig["ray_mask"](*a)

        def closest(*a):
            shared = a[6].dim() == 1
            if (self.keep("closest_shared" if shared else "closest", a, lists(a))
                    and not shared and self.last_mask is not None):
                self.calls["ray_mask" + self.tag] = tuple(
                    x.clone() for x in self.last_mask)
            return orig["closest"](*a)

        def shadow(*a):
            self.keep("shadow", a, lists(a))
            return orig["shadow"](*a)

        def ray_mask_hier(*a):
            self.last_mask = None
            nt = a[0].shape[0]
            self.keep("ray_mask_hier", a, lambda: int(
                ((a[1].view(nt, -1) != 0) & (a[0] != 0)[:, None]).sum()))
            return orig["ray_mask_hier"](*a)

        def any_hit(*a):
            self.keep("any", a, lists(a))
            return orig["any_hit"](*a)

        k.ray_mask, k.closest, k.shadow = ray_mask, closest, shadow
        k.ray_mask_hier, k.any_hit = ray_mask_hier, any_hit
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


# wrapper arguments with one row per tile (a leading light axis for the
# shadow kernel's lists) and with one row per ray; the rest (cluster
# tables, boxes, light positions, a shared origin, flags) are whole
TILE_ARGS = ("act", "sup", "tw", "tl", "tc", "sw", "sl", "sc")
RAY_ARGS = ("origin", "dirs", "t_max")


def named(kname, a):
    """The captured positional call ``a`` of kernel ``kname`` as a dict
    keyed by the wrapper's parameter names."""
    import inspect

    fn = kernel_pairs()[kname][0]
    bound = inspect.signature(fn).bind(*a)
    bound.apply_defaults()
    return dict(bound.arguments)


def n_tiles_of(p):
    return (p["act"] if "act" in p else p["tc"]).shape[-1]


def slice_args(kname, a, tiles, **replace):
    """Call ``a`` of kernel ``kname`` cut to the tiles ``tiles``, with the
    arguments named in ``replace`` replaced (bfc=..., relaxed=...)."""
    p = named(kname, a)
    nt = n_tiles_of(p)
    for k, x in p.items():
        if k in TILE_ARGS:
            lead = tuple(x.shape[:-1])
            p[k] = x.view(*lead, nt, -1)[..., tiles, :].reshape(*lead, -1).contiguous()
        elif k in RAY_ARGS and x.shape[0] == nt * 128:
            rest = tuple(x.shape[1:])
            p[k] = x.view(nt, 128, *rest)[tiles].reshape(-1, *rest).contiguous()
        elif k == "bundle":
            p[k] = x.view(8, nt, 128)[:, tiles].reshape(8, -1).contiguous()
    p.update(replace)
    return tuple(p.values())


def kernel_pairs():
    """{kernel: (wrapper, plain version)}."""
    from raytracer_tpu_torch.ops import kernels as K

    return {"ray_mask": (K.ray_mask, K.ray_mask_plain),
            "ray_mask_hier": (K.ray_mask_hier, K.ray_mask_hier_plain),
            "closest": (K.closest, K.closest_plain),
            "closest_shared": (K.closest, K.closest_plain),
            "shadow": (K.shadow, K.shadow_plain),
            "any": (K.any_hit, K.any_hit_plain)}


def equal_nan(a, b):
    import torch

    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def tie_calls(dev):
    """The closest (both call shapes) and any-hit calls of the exact-tie
    case in tests/torch_tie_case.py, on ``dev``."""
    import numpy as np
    import torch

    from raytracer_tpu_torch.ops import cluster_trace as ctr

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_tie_case import tie_case

    c = tie_case()
    on = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    lists = ctr._lists(tuple(map(on, c["thit"])), tuple(map(on, c["shit"])))
    tri, sph = on(c["tri_dat"]), on(c["sph_dat"])
    return {"closest": (*lists, on(c["origin"]), on(c["dirs"]), tri, sph, False),
            "closest_shared": (*lists, on(c["eye"]), on(c["eye_dirs"]), tri, sph,
                               False),
            "any": (*lists, on(c["origin"]), on(c["dirs"]), on(c["t_max"]), tri,
                    sph, False, False)}


def poison_calls(dev):
    """{label: shadow call} of the NaN-poison case in
    tests/torch_poison_case.py, with 1 and 2 lights, on ``dev``."""
    import numpy as np
    import torch

    from raytracer_tpu_torch.ops import cluster_trace as ctr

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_poison_case import poison_case

    on = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    calls = {}
    for nl in (1, 2):
        c = poison_case(nl)
        shit = tuple(map(on, c["shit"]))
        lists = [torch.stack(x) for x in zip(*(
            ctr._lists(tuple(map(on, th)), shit) for th in c["thit"]))]
        calls[f"poison case, {nl} light(s)"] = (
            *lists, on(c["lps"]), on(c["origin"]), on(c["planes"]),
            on(c["sph_dat"]), False)
    return calls


def check_mask_columns(label, args, gen, n_tiles=256):
    """The flat mask on a tile sample of the call ``args`` cut to column
    counts that take each instance (rays split 4 and 2 ways up to 32 and 64
    columns, one column a thread up to 128, two above): kernel == plain."""
    p = named("ray_mask", args)
    tiles = sample_tiles(p["act"], n_tiles, gen)
    sl = named("ray_mask", slice_args("ray_mask", args, tiles))
    c_all = sl["box"].shape[1]
    err, widths = 0.0, [c for c in (1, 32, 33, 64, 65, 128, 129) if c < c_all]
    for c in widths + [c_all]:
        err = max(err, kernel_vs_plain(
            "ray_mask", (sl["act"], sl["box"][:, :c].contiguous(), sl["bundle"]),
            f"{label} at C={c}"))
    log(f"  {label} ray_mask: {tiles.numel()} tiles at C in {widths + [c_all]}, "
        f"kernel == plain")
    return err


def check_hier_whole(label, args, flat=True):
    """The hierarchical mask on a whole call (its split over blocks
    depends on the launch size): kernel == plain and, when ``flat`` (coarse
    bits from _super_boxes), == the flat kernel."""
    from raytracer_tpu_torch.ops import kernels as K

    p = named("ray_mask_hier", args)
    nt, c = p["act"].shape[0], p["box"].shape[1]
    err = kernel_vs_plain("ray_mask_hier", args, f"{label} (whole call)")
    if flat:
        ref = K.ray_mask(p["act"], p["box"], p["bundle"])
        check(all(equal_nan(x, y) for x, y in zip(ref, K.ray_mask_hier(*args))),
              f"{label}: ray_mask_hier != ray_mask on the whole call")
    log(f"  {label} ray_mask_hier: the whole call ({nt} tiles, C={c}), "
        f"kernel == plain{' == the flat kernel' if flat else ''}; live chunks "
        f"per active tile {chunk_spread(p)}")
    return err


def check_hier_launch_sizes(label, args):
    """The hierarchical mask on the call ``args`` cut or repeated to the
    tile counts on each side of every change of the chunks a block that the
    kernel picks per launch (``backend.mask_hier_group``), up to 4x the
    call's tiles, busiest tiles first: kernel == plain.  Returns the max
    error."""
    import torch

    from raytracer_tpu_torch import backend

    p = named("ray_mask_hier", args)
    nt, c = p["act"].shape[0], p["box"].shape[1]
    live = ((p["sup"].view(nt, -1) != 0) & (p["act"] != 0)[:, None]).sum(1)
    order = torch.argsort(live.cpu(), descending=True, stable=True).to(live.device)
    sizes, g0 = set(), backend.mask_hier_group(1, c)
    for n in range(2, 4 * nt + 1):
        g = backend.mask_hier_group(n, c)
        if g != g0:
            sizes |= {n - 1, n}
            g0 = g
    err = 0.0
    for n in sorted(sizes):
        tiles = order.repeat(n // nt + 1)[:n]
        err = max(err, kernel_vs_plain(
            "ray_mask_hier", slice_args("ray_mask_hier", args, tiles),
            f"{label} at {n} tiles ({backend.mask_hier_group(n, c)} chunks a block)"))
    log(f"  {label} ray_mask_hier: C={c}, {nt} tiles a launch take "
        f"{backend.mask_hier_group(nt, c)} chunks a block; kernel == plain at "
        f"the tile counts on each side of every change up to {4 * nt}: "
        f"{sorted(sizes) or 'no change'}")
    return err


def hier_calls(dev):
    """{label: ray_mask_hier call} of the case in tests/torch_hier_case.py
    on ``dev``: with its coarse bits (the inactive tile's set) and with
    the bits of the port's route."""
    import numpy as np
    import torch

    from raytracer_tpu_torch.ops import cluster_trace as ctr

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_hier_case import hier_case

    c = hier_case()
    on = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    act, bundle = ctr._mask_bundle(on(c["origin"]), on(c["dirs"]), on(c["active"]),
                                   on(c["t_hi"]), 128)
    box = ctr._box_table(on(c["cmin"]), on(c["cmax"]))
    route = on(c["live"].astype(np.int32).reshape(-1))
    return {"hier case": (act, on(c["sup"]), box, bundle),
            "hier case, the route's bits": (act, route, box, bundle)}


def kernel_vs_plain(name, args, what):
    """Run kernel and plain version on the same CUDA inputs; require
    equality.  Returns the max abs difference (0 when equal)."""
    import torch

    from raytracer_tpu_torch.ops import kernels as K

    fn = kernel_pairs()[name]
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


def narrow_tiles():
    """The least launch size (tiles) for which the closest, any-hit and
    shadow kernels take 4-warp blocks (smaller launches take 16-warp
    blocks), found by bisection on the library's own rule."""
    from raytracer_tpu_torch import backend

    lo, hi = 1, 1 << 20
    check(backend.launch_threads(lo) == 512 and backend.launch_threads(hi) == 128,
          "warp walks: no 16-warp launch of 1 tile or 4-warp launch of 2^20")
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if backend.launch_threads(mid) == 512:
            lo = mid
        else:
            hi = mid
    return hi


def kernel_instance(mangled):
    """(name, template arguments) of one of the library's kernels from its
    mangled symbol (``closest<1,0,4>`` for
    ``..14closest_kernelILb1ELb0ELi4EE..``), or None."""
    import re

    k = re.search(r"\d(closest|any|shadow|ray_mask_hier|ray_mask|threefry_uniform"
                  r"|hit_record|shade_bounce)_kernel"
                  r"((?:I(?:L[a-z]\d+E)+E)?)", mangled)
    if k is None:
        return None
    args = re.findall(r"L[a-z](\d+)E", k.group(2))
    return k.group(1) + (f"<{','.join(args)}>" if args else ""), args


def ptxas_report(path):
    """{kernel instance: registers, spill and static shared bytes, threads,
    resident blocks per SM} of every kernel, from the build log's ``ptxas
    -v`` lines.  Blocks per SM are those the H100's register file allows
    (65,536 a SM, given out per warp in units of 256; at most 64 warps):
    the closest, any-hit and shadow kernels' dynamic shared memory, 16-64
    KB a block, leaves room for more."""
    import re

    out, name = {}, None
    with open(path) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                k = kernel_instance(m.group(1))
                name = None if k is None else k[0]
                if name:
                    # the warp-walk kernels' last template argument is
                    # their warps per block; the masks take 128 threads,
                    # the threefry draw 256
                    walk = name.split("<")[0] in ("closest", "any", "shadow")
                    out[name] = {"threads": 32 * int(k[1][-1]) if walk else
                                 256 if name == "threefry_uniform" else 128}
            elif name and "spill stores" in line:
                out[name]["spill_bytes"] = int(re.search(
                    r"(\d+) bytes spill stores", line).group(1))
            elif name and "registers" in line:
                regs = int(re.search(r"Used (\d+) registers", line).group(1))
                smem = re.search(r"(\d+) bytes smem", line)
                warps = out[name]["threads"] // 32
                per_warp = -(-regs * 32 // 256) * 256
                out[name].update(
                    registers=regs, static_smem=int(smem.group(1)) if smem else 0,
                    blocks_per_sm=min(65536 // per_warp, 64) // warps)
    check(out and all("registers" in r for r in out.values()),
          f"build log: no registers for some kernel instance: {out}")
    for kname in ("closest", "any", "shadow", "ray_mask_hier", "ray_mask",
                  "threefry_uniform", "hit_record", "shade_bounce"):
        check(any(n.split("<")[0] == kname for n in out),
              f"build log: no instance of {kname}_kernel: {sorted(out)}")
    return out


def sass_report(lib_path):
    """From ``cuobjdump -sass`` of the library: ({kernel instance:
    NaN-propagating FMNMX instructions, other FMNMX instructions}, {kernel
    instance: its instructions up to its last EXIT, NOPs left out}).
    nan_min / nan_max (csrc/common.cuh) must lower to one FMNMX with .NAN
    each.  The threefry draw is straight-line code, one element a thread,
    so its count is the warp instructions it issues per 32 elements."""
    import re

    cuobjdump = os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda",
                             "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300)
    check(sass.returncode == 0, f"cuobjdump -sass failed: {sass.stderr[-2000:]}")
    out, name, ops = {}, None, {}
    for line in sass.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            k = kernel_instance(m.group(1))
            name = None if k is None else k[0]
            if name:
                out[name] = [0, 0]
                ops[name] = []
            continue
        if not name:
            continue
        if "FMNMX" in line:
            out[name][0 if re.search(r"FMNMX\S*\.NAN", line) else 1] += 1
        op = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                       line)
        if op:
            ops[name].append(op.group(1).split(".")[0])
    instructions = {}
    for name, seq in ops.items():
        last = max((i for i, op in enumerate(seq) if op == "EXIT"), default=-1)
        instructions[name] = sum(op != "NOP" for op in seq[:last + 1])
    check(instructions.get("threefry_uniform", 0) > 0,
          f"SASS: no instructions counted for threefry_uniform: {instructions}")
    for kname in ("ray_mask", "ray_mask_hier", "shadow"):
        rows = [v for n, v in out.items() if n.split("<")[0] == kname]
        check(rows and all(v[0] > 0 for v in rows),
              f"SASS: {kname} has no NaN-propagating FMNMX: {out}")
    return out, instructions


def check_scene_kernels(label, calls, gen, n_tiles=256):
    """Kernel == plain on a tile sample of every captured call."""
    import torch

    from raytracer_tpu_torch.ops import kernels as K

    errs = {}
    for name, args in calls.items():
        if args is None:
            continue
        base = name.split("@")[0]             # without a Capture tag
        kname = "ray_mask" if base == "ray_mask_first" else base
        p = named(kname, args)
        if name.startswith("ray_mask"):
            counts = p["act"]
        else:  # tiles with a candidate (of any light)
            counts = (p["tc"] + p["sc"]).view(-1, n_tiles_of(p)).sum(0)
        tiles = sample_tiles(counts, n_tiles, gen)
        check(tiles.numel() > 0, f"{label} {name}: no tile with work")
        sl = slice_args(kname, args, tiles)
        err = kernel_vs_plain(kname, sl, f"{label} ({tiles.numel()} tiles)")
        extra = ""
        if kname in ("closest", "closest_shared", "any", "shadow"):
            # the sample launches 16-warp blocks; repeated past the launch
            # size that takes 4-warp blocks, it checks those too
            n = narrow_tiles()
            check(tiles.numel() < n, f"{label} {name}: the sample is not 16-warp")
            rep = tiles.repeat(n // tiles.numel() + 1)
            err = max(err, kernel_vs_plain(kname, slice_args(kname, args, rep),
                                           f"{label} ({rep.numel()} tiles)"))
            extra = f" (also as {rep.numel()} tiles: 4-warp blocks)"
        if base == "ray_mask_hier":
            # the hierarchical mask equals the flat one on the same inputs
            q = named(kname, sl)
            flat = K.ray_mask(q["act"], q["box"], q["bundle"])
            hier = K.ray_mask_hier(*sl)
            check(all(equal_nan(x, y) for x, y in zip(flat, hier)),
                  f"{label}: ray_mask_hier != ray_mask")
            chunks = q["sup"].view(tiles.numel(), -1)
            extra = (f" and == the flat kernel; {int(chunks.sum())} of "
                     f"{chunks.numel()} chunks tested")
        elif base == "any":
            # the other template instances: bfc, relaxed and both
            for bfc, relaxed in ((True, False), (False, True), (True, True)):
                err = max(err, kernel_vs_plain(
                    kname, slice_args(kname, args, tiles, bfc=bfc, relaxed=relaxed),
                    f"{label} bfc={bfc} relaxed={relaxed}"))
            extra += " (also with bfc, relaxed and both)"
        elif not name.startswith("ray_mask"):
            # the other template instance: bfc for closest, relaxed for shadow
            flag = "bfc" if name.startswith("closest") else "relaxed"
            other = not p[flag]
            err = max(err, kernel_vs_plain(
                kname, slice_args(kname, args, tiles, **{flag: other}),
                f"{label} {flag}={other}"))
            extra += f" (also {flag}={other})"
        errs[kname] = max(errs.get(kname, 0.0), err)
        if name.startswith("closest") or base == "any":
            n_over = int((p["tc"][tiles] > 48).sum())
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


def _stop_pairs(hit, live):
    """(n, 128) pairs each ray tests in one visit when it stops at its first
    hit: the lanes up to the first hit lane, all 128 on a miss; 0 for rays
    not ``live``.  hit: (n, 128 rays, 128 lanes) bool."""
    import torch

    first = hit.to(torch.uint8).argmax(-1)      # the first hit lane
    return torch.where(hit.any(-1), first + 1, 128) * live


def any_needed(p):
    """[triangle pairs, sphere pairs, triangle visits, sphere visits] that
    the any_hit call ``p`` (by name) needs: every ray stops at its first
    hit and a tile once all its rays are found, as the kernel's loops do.
    Replayed with the plain version's visit tables and tests."""
    import torch

    from raytracer_tpu_torch.ops import kernels as K

    tri, sph, tc = p["tri_dat"], p["sph_dat"], p["tc"]
    nt, ct, cs = tc.shape[0], tri.shape[1] // 128, sph.shape[1] // 128
    o, d = p["origin"].view(nt, 128, 3), p["dirs"].view(nt, 128, 3)
    tm = p["t_max"].view(nt, 128, 1)
    acc = torch.zeros(4, dtype=torch.int64, device=tri.device)
    for a, e in K._chunks(nt, 128 * 128):
        ox, oy, oz = (o[a:e, :, None, c] for c in range(3))
        dx, dy, dz = (d[a:e, :, None, c] for c in range(3))
        done = torch.zeros((e - a, 128), dtype=torch.bool, device=tri.device)
        tri_vis = K._visit_table(p["tw"], p["tl"], tc, ct, K.MAX_TRI_LIST, a, e)
        sph_vis = (K._dense_table(p["sc"], cs, a, e) if cs <= K.DENSE_SPH_ROWS
                   else K._visit_table(p["sw"], p["sl"], p["sc"], cs,
                                       K.MAX_SPH_LIST, a, e))
        for side, vis in ((0, tri_vis), (1, sph_vis)):
            for v in range(vis.shape[1]):
                k = vis[:, v]
                if side == 0:
                    t, ok = K._tri_test(K._gather(tri, k), ox, oy, oz, dx, dy,
                                        dz, p["bfc"])
                    hit = ok & (t < tm[a:e])
                else:
                    hit = K._sph_occluded(K._gather(sph, k), ox, oy, oz, dx,
                                          dy, dz, p["relaxed"], tm[a:e])
                live = ~done & (k >= 0)[:, None]
                acc[side] += _stop_pairs(hit, live).sum()
                acc[2 + side] += live.any(1).sum()
                done |= hit.any(-1) & live
    return acc.tolist()


def shadow_needed(p):
    """[triangle pairs, sphere pairs, triangle visits, sphere visits] that
    the shadow call ``p`` (by name) needs, per light: every ray stops at
    its first plane hit (a lane whose four planes are all >= 0) and its
    first sphere hit, a tile once all its rays are found.  A NaN plane
    value clears its lane for every visit (the running max propagates
    it), so a ray that meets one needs all its visits, and so does its
    tile.  Replayed with the plain version's visit tables and tests."""
    import torch

    from raytracer_tpu_torch.ops import kernels as K

    planes, sph, lps, tc = p["planes"], p["sph_dat"], p["lps"], p["tc"]
    nl, nt = tc.shape
    ct, cs = planes.shape[2] // 128, sph.shape[1] // 128
    o = p["origin"].view(nt, 128, 3)
    acc = torch.zeros(4, dtype=torch.int64, device=planes.device)
    for a, e in K._chunks(nt, 128 * 128):
        n = e - a
        ox, oy, oz = (o[a:e, :, None, c] for c in range(3))
        seg = [(lps[3 * l] - ox, lps[3 * l + 1] - oy, lps[3 * l + 2] - oz)
               for l in range(nl)]
        done = []
        for l in range(nl):
            vis = K._visit_table(p["tw"][l], p["tl"][l], tc[l], ct,
                                 K.MAX_TRI_LIST, a, e)
            run = torch.full((n, 128, 128), -float("inf"), device=planes.device)
            stop = torch.zeros((n, 128), dtype=torch.int64, device=planes.device)
            every = torch.zeros_like(stop)
            tile_stop = torch.zeros((n,), dtype=torch.int64, device=planes.device)
            tile_every = torch.zeros_like(tile_stop)
            poison = torch.zeros((n, 128), dtype=torch.bool, device=planes.device)
            dn = torch.zeros((n, 128), dtype=torch.bool, device=planes.device)
            for v in range(vis.shape[1]):
                k = vis[:, v]
                valid = (k >= 0)[:, None]
                m = K._plane_min(K._gather(planes[l], k), ox, oy, oz)
                m = torch.where(valid[:, :, None], m, -float("inf"))
                run = torch.maximum(run, m)
                stop += _stop_pairs(m >= 0.0, ~dn & valid)
                every += 128 * valid
                tile_stop += (~dn & valid).any(1)
                tile_every += valid[:, 0]
                poison |= torch.isnan(m).any(-1)
                dn |= (m >= 0.0).any(-1) & valid
            acc[0] += torch.where(poison, every, stop).sum()
            acc[2] += torch.where(poison.any(1), tile_every, tile_stop).sum()
            dn = (run >= 0.0).any(-1)          # the kernel's occlusion bit
            if cs > K.DENSE_SPH_ROWS:
                svis = K._visit_table(p["sw"][l], p["sl"][l], p["sc"][l], cs,
                                      K.MAX_SPH_LIST, a, e)
                for v in range(svis.shape[1]):
                    k = svis[:, v]
                    hit = K._sph_occluded(K._gather(sph, k), ox, oy, oz,
                                          *seg[l], p["relaxed"])
                    live = ~dn & (k >= 0)[:, None]
                    acc[1] += _stop_pairs(hit, live).sum()
                    acc[3] += live.any(1).sum()
                    dn |= hit.any(-1) & live
            done.append(dn)
        if cs <= K.DENSE_SPH_ROWS:
            # one pass over every sphere cluster for all lights, gated on
            # any light having a sphere candidate
            gate = (p["sc"][:, a:e] != 0).any(0)[:, None]
            for k in range(cs):
                rows = sph[:, k * 128:(k + 1) * 128][:, None, None, :]
                staged = torch.zeros((n,), dtype=torch.bool, device=sph.device)
                for l in range(nl):
                    hit = K._sph_occluded(rows, ox, oy, oz, *seg[l], p["relaxed"])
                    live = ~done[l] & gate
                    acc[1] += _stop_pairs(hit, live).sum()
                    staged |= live.any(1)
                    done[l] |= hit.any(-1) & live
                acc[3] += staged.sum()
    return acc.tolist()


def work(name, args):
    """(ops, bytes) the call's data needs: the mask's tested chunks, the
    closest kernel's listed pairs (a closest hit needs every one), and for
    the any-hit kernels the pairs up to each ray's first hit."""
    import torch

    p = named(name, args)
    if name == "ray_mask":
        act, box, bundle = p["act"], p["box"], p["bundle"]
        c = box.shape[1]
        ops = int((act != 0).sum()) * 128 * c * OPS["ray_mask"]
        out = act.shape[0] * c * 8
        return ops, nbytes(act, box[[0, 1, 2, 4, 5, 6]], bundle[:7]) + out
    if name == "ray_mask_hier":
        # pairs of the chunks tested: coarse bit set in an active tile,
        # the last chunk counted at its real width
        act, sup, box, bundle = p["act"], p["sup"], p["box"], p["bundle"]
        nt, c = act.shape[0], box.shape[1]
        width = torch.full((sup.numel() // nt,), 128, device=sup.device)
        width[-1] = c - 128 * (width.numel() - 1)
        tested = (sup.view(nt, -1) != 0) & (act != 0)[:, None]
        ops = int((tested * width).sum()) * 128 * OPS["ray_mask"]
        out = nt * c * 8
        return ops, nbytes(act, sup, box[[0, 1, 2, 4, 5, 6]], bundle[:7]) + out
    lists = nbytes(*(p[k] for k in ("tw", "tl", "tc", "sw", "sl", "sc")))
    sph = p["sph_dat"]
    if name.startswith("closest"):
        tc, sc, tri = p["tc"], p["sc"], p["tri_dat"]
        cs = sph.shape[1] // 128
        tri_v = int(tc.sum())
        sph_v = (int(((sc > 0).sum())) * cs if cs <= 8 else int(sc.sum()))
        per = OPS["tri_shared"] if p["origin"].dim() == 1 else OPS["tri"]
        ops = (tri_v * per + sph_v * OPS["sph"]) * 128 * 128
        byt = (lists + nbytes(p["origin"], p["dirs"])
               + min(tri.numel(), tri_v * 12 * 128) * 4
               + min(sph.numel(), sph_v * 4 * 128) * 4 + p["dirs"].shape[0] * 8)
        return ops, byt
    if name == "any":
        tri_p, sph_p, tri_v, sph_v = any_needed(p)
        tri, per_tri, rows, per_ray = p["tri_dat"], OPS["tri_any"], 12, (
            nbytes(p["origin"], p["dirs"], p["t_max"]))
    else:
        tri_p, sph_p, tri_v, sph_v = shadow_needed(p)
        tri, per_tri, rows, per_ray = p["planes"], OPS["plane"], 16, (
            nbytes(p["lps"], p["origin"]))
    ops = tri_p * per_tri + sph_p * OPS["sph_shadow"]
    byt = (lists + per_ray + min(tri.numel(), tri_v * rows * 128) * 4
           + min(sph.numel(), sph_v * 4 * 128) * 4 + p["origin"].shape[0] * 4)
    return ops, byt


def profile_frame(frame, results, key_name="profile"):
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
    mine = sum(r[0] for r in rows if kernel_of(r[2]) is not None)
    log(f"  profiled frame: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
        f"(idle share {1 - busy / wall_ms:.3f}), the CUDA kernels "
        f"{mine:.3f} ms, other device work {busy - mine:.3f} ms")
    for ms, count, key in rows[:20]:
        log(f"    {ms:9.3f} ms  {count:5d}x  {key[:100]}")
    host = host_side(prof)
    log(f"  host side of the profiled frame: {host['top_level_ops']} top-level "
        f"PyTorch ops, {host['launches']} kernel launches, CPU busy "
        f"{host['cpu_ms']:.3f} ms of the {wall_ms:.3f} ms wall")
    for what in ("syncs", "sorts", "runtime"):
        for key, (count, ms) in host[what].items():
            log(f"    {what:7s} {key[:60]:60s} {count:6d}x  {ms:9.3f} ms")
    log("    top host rows by self CPU time:")
    for key, count, ms in host["top"][:12]:
        log(f"      {ms:9.3f} ms  {count:6d}x  {key[:80]}")
    by_kernel = {}
    for ms, count, key in rows:
        name = kernel_of(key)
        if name is not None:
            acc = by_kernel.setdefault(name, [0.0, 0])
            acc[0] += ms
            acc[1] += count
    results[key_name] = {"wall_ms": wall_ms, "device_busy_ms": busy,
                         "kernels_ms": mine, "host": host, "by_kernel": by_kernel,
                         "top": [[ms, c, k[:100]] for ms, c, k in rows[:40]]}


# a profiler event name's kernel row: the closest kernel's two call shapes
# are its SHARED template instances
EVENT_ROWS = (("ray_mask_hier_kernel", "ray_mask_hier"),
              ("ray_mask_kernel", "ray_mask"),
              ("closest_kernel<true", "closest_shared"),
              ("closest_kernel<false", "closest"),
              ("shadow_kernel", "shadow"), ("any_kernel", "any"),
              ("threefry_uniform_kernel", "threefry"),
              ("hit_record_kernel", "hit_record"),
              ("shade_bounce_kernel", "shade_bounce"),
              ("compact_kernel", "compact"),
              ("tile_mask_kernel", "tile_mask"))


def kernel_of(event_name):
    for key, name in EVENT_ROWS:
        if key in event_name:
            return name
    return None


def frame_call(cap, name):
    """The busiest captured call of kernel ``name`` in a frame; for the flat
    mask of the big terrain, whose only flat masks are the supercluster
    passes (C = 32), the busiest of those."""
    args = cap.calls.get(name)
    if args is None and name == "ray_mask":
        args = cap.calls.get("ray_mask_first")
    return args


def _spread(v):
    import torch

    v = v.double()
    if v.numel() == 0:
        return {"tiles": 0}
    return {"tiles": int(v.numel()), "mean": float(v.mean()),
            "p99": float(torch.quantile(v, 0.99)), "max": int(v.max())}


def visit_spread(p):
    """Visits per tile with work (tc + sc, summed over lights) of a call
    ``p`` (by name): {tiles, mean, p99, max}."""
    nt = p["tc"].shape[-1]
    v = (p["tc"] + p["sc"]).view(-1, nt).sum(0)
    return _spread(v[v > 0])


def chunk_spread(p):
    """Live chunks (coarse bit set) per active tile of a ray_mask_hier call
    ``p`` (by name): {tiles, mean, p99, max}, with the live (tile, chunk)
    items and all of them."""
    nt = p["act"].shape[0]
    act = p["act"] != 0
    live = ((p["sup"].view(nt, -1) != 0) & act[:, None]).sum(1)[act]
    return {**_spread(live), "items": int(live.sum()), "of": p["sup"].numel()}


def call_spread(name, args):
    """The work spread of a captured call: live chunks per active tile for
    the hierarchical mask, visits per tile for the cluster walks, None for
    the flat mask."""
    if name == "ray_mask":
        return None
    p = named(name, args)
    return chunk_spread(p) if name == "ray_mask_hier" else visit_spread(p)


# PyTorch ops that copy a device value to the host and wait for it
SYNC_OPS = ("aten::_local_scalar_dense", "aten::nonzero", "aten::item",
            "aten::is_nonzero", "aten::unique_consecutive", "aten::_unique2")


def host_side(prof):
    """The host's share of one profiled frame: top-level PyTorch ops,
    kernel launches, the ops that wait for the device, the sorts and the
    CUDA runtime calls, each with its count and self CPU ms."""
    from torch.autograd import DeviceType

    by_name, top_level = {}, 0
    for ev in prof.events():
        if ev.device_type != DeviceType.CPU:
            continue
        acc = by_name.setdefault(ev.name, [0, 0.0])
        acc[0] += 1
        acc[1] += ev.self_cpu_time_total / 1e3
        if ev.cpu_parent is None and ev.name.startswith("aten::"):
            top_level += 1
    pick = lambda f: {k: tuple(v) for k, v in sorted(by_name.items()) if f(k)}
    runtime = pick(lambda k: k.startswith("cu"))
    return {
        "top_level_ops": top_level,
        "launches": sum(v[0] for k, v in by_name.items() if "LaunchKernel" in k),
        "cpu_ms": sum(v[1] for v in by_name.values()),
        "syncs": pick(lambda k: k in SYNC_OPS),
        "sorts": pick(lambda k: k in ("aten::sort", "aten::argsort")),
        "runtime": runtime,
        "top": sorted(([k, v[0], v[1]] for k, v in by_name.items()),
                      key=lambda r: -r[2])[:40],
    }


def time_call(fn, args, n, spin=1 << 24):
    """ms per launch of fn(*args) on the device, over n launches queued
    behind a device spin of ``spin`` cycles: the host enqueues them all
    while the card spins, so a launch shorter than the host's own cost per
    call is timed on the device, not at the host's enqueue rate.  When the
    spin ends before the last launch is queued, again with twice the
    spin."""
    import torch

    fn(*args)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin)
    e0.record()
    for _ in range(n):
        fn(*args)
    e1.record()
    late = e0.query()   # the spin was over before the host was done
    torch.cuda.synchronize()
    if late and spin < 1 << 30:
        return time_call(fn, args, n, 2 * spin)
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
    from raytracer_tpu_torch.pipeline import render_one_camera

    cam = meta.cameras[0]
    if res is not None:
        cam = dataclasses.replace(cam, width=res, height=res)
    return render_one_camera(data, meta, cam, cset, ssaa=ssaa, device=device)[0]


def build(scene_fn, device, **kw):
    from raytracer_tpu_torch.models.bvh import build_bvh
    from raytracer_tpu_torch.models.clusters import build_clusters

    data, meta = scene_fn(device=device, **kw)
    cset = build_clusters(data, meta, build_bvh(data, meta))
    return data, meta, cset


def moved(xs, dev):
    """The tensors, scenes and accelerators of ``xs`` on ``dev`` (other
    items as they are)."""
    return tuple(x.to(dev) if hasattr(x, "to") else x for x in xs)


def to_cpu(data, meta, cset):
    """(data, meta, cset) with every tensor moved to the CPU: the same
    arrays, not a second build."""
    return moved((data, meta, cset), "cpu")


def drive_path(label, data, meta, cset, results, key, must, must_not=()):
    """The main path of one scene at --ssaa 2 through render_one_camera:
    a warm-up frame (the programs' captures), one replayed frame with the
    launch counts reset just before and read just after (every kernel of
    ``must`` launched, none of ``must_not``), the same frame eager
    (``whitted.eager()``: equal image and launches) with the kernel inputs
    captured, 5 timed frames, a finite-radiance and coverage check, the
    scene through a 64x64 camera against the CPU render (eager, captured
    too, and replayed), and one profiled frame.  Returns (capture, 64x64
    capture, launches)."""
    import numpy as np
    import torch

    from raytracer_tpu_torch.models.whitted import eager, render_camera
    from raytracer_tpu_torch.ops import kernels as K
    from raytracer_tpu_torch.utils.ppm import write_ppm

    dev = cset.tri_dat.device
    cam = meta.cameras[0]
    rays = cam.width * 2 * cam.height * 2
    check(rays == 4_194_304, f"{rays} rays")
    render_scene(data, meta, cset, 2, dev)          # warm-up: the captures
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    img = render_scene(data, meta, cset, 2, dev)    # replays
    torch.cuda.synchronize()
    launches = dict(K.launches)
    peak = torch.cuda.max_memory_allocated()
    log(f"  launches in one frame: {launches}")
    log(f"  peak device memory of the frame: {peak} bytes ({peak / 2**30:.3f} "
        f"GiB) allocated outside the graphs' pool; reserved "
        f"{torch.cuda.memory_reserved()} bytes")
    for name in must:
        check(launches[name] > 0, f"{name} was not launched on the path")
    for name in must_not:
        check(launches[name] == 0, f"{name} was launched on the path")
    # the same frame eager, its kernel calls recorded: a replay calls no
    # wrapper
    K.reset_launches()
    with Capture(K) as cap, eager():
        eager_img = render_scene(data, meta, cset, 2, dev)
    torch.cuda.synchronize()
    check(dict(K.launches) == launches,
          f"{label}: eager launches {dict(K.launches)}, replayed {launches}")
    check(np.array_equal(eager_img, img), f"{label}: the eager frame differs")
    # each frame's wall time, with the process's CPU time and involuntary
    # context switches (the host descheduling it) over the same frame
    times, cpu, nivcsw = [], [], []
    for _ in range(5):
        torch.cuda.synchronize()
        r0 = resource.getrusage(resource.RUSAGE_SELF)
        t0 = time.perf_counter()
        render_scene(data, meta, cset, 2, dev)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        r1 = resource.getrusage(resource.RUSAGE_SELF)
        cpu.append((r1.ru_utime + r1.ru_stime - r0.ru_utime - r0.ru_stime) * 1e3)
        nivcsw.append(r1.ru_nivcsw - r0.ru_nivcsw)
    frame_ms = statistics.median(times)
    log(f"  frame ms (5 warm runs): {[round(t, 3) for t in times]}")
    log(f"  process CPU ms over each: {[round(t, 3) for t in cpu]}; "
        f"involuntary context switches: {nivcsw}")
    log(f"  median {frame_ms:.3f} ms/frame, {rays / frame_ms / 1e3:.3f} Mrays/s "
        f"(primary rays at ssaa 2)")
    col = render_camera(data, meta, cam.scaled(2), cset, device=dev)
    check(bool(torch.isfinite(col).all()), f"{label} radiance has NaN/inf")
    del col
    bg = np.array([20, 30, 60], np.uint8)
    share = float((img != bg).any(-1).mean())
    log(f"  radiance finite; image {img.shape}, non-background share {share:.4f}")
    write_ppm(os.path.join(OUT, label + ".ppm"), img)
    check(img.shape == (1024, 1024, 3) and share > 0.25,
          f"{label}: the terrain covers less than a quarter of the frame")
    # the same scene through a 64x64 camera: wide tiles whose shortlists
    # overflow (the bitmask scan), checked against the CPU render
    cpu_img = render_scene(*to_cpu(data, meta, cset), 1, "cpu", res=64)
    with Capture(K) as small_cap, eager():
        cuda_img = render_scene(data, meta, cset, 1, dev, res=64)
    compare_images(cuda_img, cpu_img, f"{label} at 64x64, cuda vs cpu")
    compare_images(render_scene(data, meta, cset, 1, dev, res=64), cpu_img,
                   f"{label} at 64x64 replayed, cuda vs cpu")
    profile_frame(lambda: render_scene(data, meta, cset, 2, dev), results,
                  key + "_profile")
    prof = results.get(key + "_profile")
    if prof:
        # the profiler slows the host; the device work it saw against the
        # unprofiled median frame
        log(f"  device busy {prof['device_busy_ms']:.3f} ms of the unprofiled "
            f"median {frame_ms:.3f} ms: idle share "
            f"{1 - prof['device_busy_ms'] / frame_ms:.3f}")
    results[key] = {"ms": frame_ms, "runs_ms": times, "runs_cpu_ms": cpu,
                    "runs_nivcsw": nivcsw,
                    "mrays_per_s": rays / frame_ms / 1e3,
                    "launches": launches, "non_background": share,
                    "peak_bytes": peak}
    return cap, small_cap, launches


# ---------------------------------------------------------------------------
# the render modes beyond one whole frame (phases 2 and 6)
# ---------------------------------------------------------------------------

def quiet(fn, *a, **kw):
    """(fn(*a, **kw), what it printed): its standard output kept out of the
    log."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        return fn(*a, **kw), buf.getvalue().strip()


ENTRY_MUST = ("ray_mask", "closest_shared", "closest", "shadow")


def entry_cli_outputs(xml, results):
    """The entry scene through the CLI at --ssaa 2 in the outputs and modes
    beyond a PPM of a whole frame (PNG, EXR, the ACES curve, a --chunk
    that streams 8 bands, jitter and adaptive under one --seed), on CUDA
    against the CPU through the diff CLI (exit 0) and the image bar, with
    the launch counts of each CUDA run (its single light takes the 1-light
    shadow call); then
    --accel-cache twice on CUDA: the second run loads the cache and builds
    nothing."""
    from raytracer_tpu_torch import render as cli
    from raytracer_tpu_torch.compare import _read as read_image
    from raytracer_tpu_torch.compare import main as compare_main
    from raytracer_tpu_torch.ops import kernels as K

    cases = [(["--format", "png"], "entry_scene.png"),
             (["--format", "exr"], "entry_scene.exr"),
             (["--tone", "aces", "--format", "png"], "entry_scene.png"),
             (["--chunk", "2048"], "entry_scene.ppm"),
             (["--ssaa-mode", "jitter", "--seed", "3"], "entry_scene.ppm"),
             (["--ssaa-mode", "adaptive", "--seed", "3", "--json-metrics"],
              "entry_scene.ppm")]
    out_rows = {}
    for extra, name in cases:
        label = " ".join(extra)
        tag = "_".join(a.strip("-") for a in extra)
        paths = {}
        for d in ("cuda", "cpu"):
            out = os.path.join(OUT, f"entry_{d}_{tag}")
            K.reset_launches()
            quiet(cli.main, [xml, "--ssaa", "2", *extra, "--device", d,
                             "--out-dir", out])
            if d == "cuda":
                launches = dict(K.launches)
            paths[d] = os.path.join(out, name)
        for k in ENTRY_MUST + (("threefry",) if "--seed" in extra else ()):
            check(launches[k] > 0, f"entry {label}: {k} was not launched")
        rc, diff = quiet(compare_main, [paths["cuda"], paths["cpu"]])
        log(f"  entry {label}: launches {launches}; diff CLI cuda vs cpu: rc {rc} "
            f"{diff}")
        check(rc == 0, f"entry {label}: the diff CLI finds cuda and cpu apart")
        compare_images(read_image(paths["cuda"]), read_image(paths["cpu"]),
                       f"entry {label} cuda vs cpu")
        out_rows[label] = {"launches": launches, "compare": json.loads(diff)}
    cache = os.path.join(OUT, "entry_accel.npz")
    if os.path.exists(cache):
        os.remove(cache)
    builds = []
    build_bvh = cli.build_bvh
    cli.build_bvh = lambda *a: builds.append(1) or build_bvh(*a)
    try:
        imgs = []
        for i in range(2):
            out = os.path.join(OUT, f"entry_accel_{i}")
            quiet(cli.main, [xml, "--ssaa", "2", "--accel-cache", cache,
                             "--device", "cuda", "--out-dir", out])
            imgs.append(read_image(os.path.join(out, "entry_scene.ppm")))
    finally:
        cli.build_bvh = build_bvh
    check(len(builds) == 1, f"--accel-cache: {len(builds)} builds in two runs")
    check((imgs[0] == imgs[1]).all(), "--accel-cache: the loaded cache renders "
          "another image")
    log(f"  entry --accel-cache: the second run loaded {os.path.getsize(cache)} "
        "bytes and built nothing; the same image")
    results["entry_cli"] = out_rows


CLI_ENGINES = ("brute", "bvh", "cluster", "auto")


def entry_engines(xml, results):
    """The entry scene through the CLI at --ssaa 2 with each --engine, on
    CUDA and on the CPU: each engine's CUDA image equals its CPU image (0
    differing channels through the diff CLI), every engine's CUDA run goes
    through captured programs, brute and bvh launch no kernel and cluster
    and auto the entry path's, and brute's and bvh's images meet the
    image bar against cluster's (the exact-t tie class)."""
    from raytracer_tpu_torch import render as cli
    from raytracer_tpu_torch.compare import _read as read_image
    from raytracer_tpu_torch.compare import main as compare_main
    from raytracer_tpu_torch.models import programs
    from raytracer_tpu_torch.ops import kernels as K

    imgs, rows = {}, {}
    for engine in CLI_ENGINES:
        paths = {}
        for d in ("cuda", "cpu"):
            out = os.path.join(OUT, f"entry_engine_{engine}_{d}")
            K.reset_launches()
            c0 = programs.stats["captures"]
            _, text = quiet(cli.main, [xml, "--ssaa", "2", "--engine", engine,
                                       "--device", d, "--out-dir", out])
            if d == "cuda":
                launches = dict(K.launches)
                captures = programs.stats["captures"] - c0
                check(captures > 0, f"--engine {engine} on CUDA captured no "
                      "program")
            paths[d] = os.path.join(out, "entry_scene.ppm")
        named = "cluster" if engine == "auto" else engine
        check(f"engine={named}" in text, f"--engine {engine}: {text}")
        if named == "cluster":
            for k in ENTRY_MUST:
                check(launches[k] > 0, f"--engine {engine}: {k} was not launched")
        else:
            check(sum(launches.values()) == 0,
                  f"--engine {engine} launched kernels: {launches}")
        rc, diff = quiet(compare_main, [paths["cuda"], paths["cpu"]])
        stats = json.loads(diff)
        log(f"  entry --engine {engine}: launches {launches}, {captures} "
            f"captures; diff CLI cuda vs cpu: rc {rc} {diff}")
        check(rc == 0 and stats["differing"] == 0,
              f"--engine {engine}: the CUDA and CPU images differ")
        imgs[engine] = read_image(paths["cuda"])
        rows[engine] = {"launches": launches, "captures": captures,
                        "compare": stats}
    for engine in ("brute", "bvh"):
        compare_images(imgs[engine], imgs["cluster"],
                       f"entry --engine {engine} vs cluster on CUDA")
    results["entry_engines"] = rows


TRAIN_MUST = ("ray_mask", "closest", "shadow")


def _losses(text):
    import re

    return [float(x) for x in re.findall(r"loss (\S+)  \(", text)]


def entry_train_cli(xml, results):
    """The train CLI on CUDA: the entry scene with its first material's
    diffuse albedo off, a PNG target rendered by the CLI from the true
    scene, --steps 3 with --checkpoint and --out, then a resume for
    --steps 2.  The training steps launch the flat mask, the per-ray-origin
    closest hit and the 1-light shadow kernel, and no shared-origin
    closest hit (the --out render, counted apart, does)."""
    from raytracer_tpu_torch import render as cli
    from raytracer_tpu_torch import train as train_cli
    from raytracer_tpu_torch.models import whitted
    from raytracer_tpu_torch.ops import kernels as K
    from raytracer_tpu_torch.utils.ppm import read_ppm

    out = os.path.join(OUT, "entry_train")
    quiet(cli.main, [xml, "--ssaa", "1", "--format", "png", "--device", "cuda",
                     "--out-dir", out])
    target = os.path.join(out, "entry_scene.png")
    with open(xml) as f:
        text = f.read()
    bad = text.replace("<DiffuseReflectance>0.8 0.4 0.2</DiffuseReflectance>",
                       "<DiffuseReflectance>0.4 0.4 0.4</DiffuseReflectance>")
    check(bad != text, "the entry scene's first diffuse albedo was not found")
    scene = os.path.join(out, "perturbed.xml")
    with open(scene, "w") as f:
        f.write(bad)
    ck, rec = os.path.join(out, "ck.npz"), os.path.join(out, "rec.ppm")
    if os.path.exists(ck):
        os.remove(ck)
    at_out = {}

    def counted(f):
        def render(*a, **kw):
            at_out.update(K.launches)
            return f(*a, **kw)
        return render

    args = [scene, "--target", target, "--checkpoint", ck, "--log-every", "1",
            "--device", "cuda"]
    K.reset_launches()
    with patched(whitted, "render_camera", counted):
        _, first = quiet(train_cli.main, args + ["--steps", "3", "--out", rec])
    total = dict(K.launches)
    steps = dict(at_out)
    render = {k: total[k] - steps[k] for k in total}
    _, second = quiet(train_cli.main, args + ["--steps", "2"])
    l1, l2 = _losses(first), _losses(second)
    log(f"  train CLI --steps 3: losses {l1}; launches of the 3 steps {steps}, "
        f"of the --out render {render}")
    log(f"  train CLI resumed, --steps 2: losses {l2}")
    for k in TRAIN_MUST:
        check(steps[k] > 0, f"train CLI: {k} was not launched in the steps")
    check(steps["closest_shared"] == 0, "train CLI: closest_shared launched")
    check("Resumed train state" in second, "train CLI: no resume")
    check(len(l1) == 3 and len(l2) == 2 and all(map(math.isfinite, l1 + l2))
          and l2[-1] < l1[0], f"train CLI: losses {l1} then {l2}")
    check(read_ppm(rec).shape == (64, 64, 3), "train CLI: --out image")
    results["entry_train_cli"] = {"losses": l1, "resumed_losses": l2,
                                  "step_launches": steps,
                                  "out_render_launches": render}


def training_setup(dev):
    """Phase 7's training problem: (data, meta, clusters, origin, dirs,
    target, start) of the full-width terrain, its 1024x1024 camera's
    1,048,576 eye rays in raster order, the target the forward radiance of
    the true scene, the start with mat_diffuse x 0.5 and light_int x 0.7."""
    import torch

    from raytracer_tpu_torch.models.whitted import render_rays
    from raytracer_tpu_torch.ops.camera import camera_vectors, eye_rays_from
    from raytracer_tpu_torch.utils.synth import terrain_scene

    data, meta, cset = build(terrain_scene, dev, cells=126, res=1024,
                             mirror_stripes=True)
    cam = meta.cameras[0]
    rays = cam.width * cam.height
    check(rays == 1_048_576 and meta.n_tris == 31_752 and meta.n_lights == 2,
          f"full-width terrain: {rays} rays, {meta.n_tris} triangles")
    vec = torch.from_numpy(camera_vectors(cam)).to(dev)
    origin, dirs = eye_rays_from(vec, cam.width, cam.height)
    with torch.no_grad():
        target = render_rays(data, meta, origin, dirs, cset, engine="cluster")
    bad = dataclasses.replace(data, mat_diffuse=data.mat_diffuse * 0.5,
                              light_int=data.light_int * 0.7)
    return data, meta, cset, origin, dirs, target, bad


def eager_step_calls(label, one, launches):
    """One more training step ``one()`` under ``whitted.eager()`` with its
    kernel calls recorded (a replayed graph calls no wrapper, and a
    capture runs no Python that reads the device): its launches must equal
    ``launches``, a replayed step's.  Returns the ``Capture``."""
    import torch

    from raytracer_tpu_torch.models.whitted import eager
    from raytracer_tpu_torch.ops import kernels as K

    K.reset_launches()
    with Capture(K) as cap, eager():
        one()
    torch.cuda.synchronize()
    check(dict(K.launches) == launches, f"{label}: eager step launches "
          f"{dict(K.launches)}, replayed {launches}")
    return cap


def train_full_width(dev, results, checked):
    """Phase 7: make_train_step on the full-width terrain (cluster engine,
    fields mat_diffuse and light_int, lr 3e-2) over its 1024x1024 camera's
    1,048,576 eye rays in raster order every step, the target the port's
    forward radiance of the true scene, the start mat_diffuse x 0.5 and
    light_int x 0.7: 5 steps on the replayed route (the first eager, then
    captured, with the launch counts reset just before and read just
    after), the loss falling and every gradient finite; a sixth step
    eager (``eager_step_calls``: the same launches, its kernel calls held
    against the plain versions); s/step (median of steps 2-5, replayed,
    synchronized), rays/s, peak device memory of steps 2-5, one profiled
    step (device busy, idle share); one step with vertices too, its
    gradients finite.  Returns the launches of one step."""
    import torch

    from raytracer_tpu_torch.ops import kernels as K
    from raytracer_tpu_torch.parallel.train import init_state, make_train_step

    _, meta, cset, origin, dirs, target, bad = training_setup(dev)
    rays = dirs.shape[0]
    step = make_train_step(meta, lr=3e-2, engine="cluster", device=dev)
    state = init_state(bad, fields=("mat_diffuse", "light_int"))

    def one():
        nonlocal state
        state, loss = step(state, bad, origin, dirs, target, accel=cset)
        return loss

    losses, times = [], []
    for i in range(5):
        torch.cuda.synchronize()
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if i == 0:
            K.reset_launches()
        loss = one()
        torch.cuda.synchronize()
        if i == 0:
            launches = dict(K.launches)
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
        for f, p in state.params.items():
            check(bool(torch.isfinite(p.grad).all()), f"step {i + 1}: {f} grad")
    peak = torch.cuda.max_memory_allocated()
    s_step = statistics.median(times[1:])
    cap = eager_step_calls("training step", one, launches)
    log(f"  launches in one step: {launches}")
    for name in TRAIN_MUST:
        check(launches[name] > 0, f"training step: {name} was not launched")
    check(launches["closest_shared"] == 0, "training step: closest_shared launched")
    # every bounce's shadow wave is one launch over all the lights (the
    # TPU's _shadow_kernel_ml), not one 1-light launch per light
    nl_call = named("shadow", cap.calls["shadow"])["planes"].shape[0]
    check(launches["shadow"] == meta.max_depth + 1 and nl_call == meta.n_lights,
          f"training step: {launches['shadow']} shadow launches over "
          f"{nl_call} lights, want {meta.max_depth + 1} over {meta.n_lights}")
    log(f"  losses {losses}; s/step {[round(t, 4) for t in times]} (first: "
        f"eager, then the capture); median of steps 2-5 (replayed) {s_step:.4f} s, "
        f"{rays / s_step / 1e6:.3f} Mrays/s; peak {peak} bytes "
        f"({peak / 2**30:.3f} GiB)")
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"training losses {losses}")
    log(f"  training step calls captured: {sorted(cap.calls)}")
    checked("full-width training step", cap.calls)
    del cap
    profile_frame(one, results, "train_profile")
    prof = results.get("train_profile")
    busy = prof["device_busy_ms"] if prof else None
    idle = 1 - busy / (s_step * 1e3) if prof else None
    log(f"  profiled step: device busy {busy} ms of the unprofiled median "
        f"{s_step * 1e3:.3f} ms: idle share {idle}")
    vstate = init_state(bad, fields=("mat_diffuse", "light_int", "vertices"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vstate, vloss = step(vstate, bad, origin, dirs, target, accel=cset)
    torch.cuda.synchronize()
    v_s = time.perf_counter() - t0
    for f, p in vstate.params.items():
        check(bool(torch.isfinite(p.grad).all()), f"step with vertices: {f} grad")
    log(f"  one step with vertices: loss {float(vloss):.6f}, {v_s:.4f} s, "
        f"every gradient finite (max |d vertices| "
        f"{float(vstate.params['vertices'].grad.abs().max()):.6g})")
    results["train"] = {"rays": rays, "losses": losses, "runs_s": times,
                        "s_per_step": s_step, "rays_per_s": rays / s_step,
                        "peak_bytes": peak, "device_busy_ms": busy,
                        "idle_share": idle, "launches": launches,
                        "vertices_step_s": v_s}
    return launches


def train_cuda_vs_cpu(dev, results):
    """Phase 7b: one training step (fields mat_diffuse, light_int,
    light_pos, vertices) on CUDA and on the CPU from the same perturbed
    scene and target, for brute, bvh and cluster, on the full-width
    terrain through a 64x64 camera and on the entry scene: the loss to
    rtol 1e-5, each field's gradient within 1e-3 of its max |g|."""
    import torch

    from raytracer_tpu_torch.models.bvh import build_bvh, device_bvh
    from raytracer_tpu_torch.models.clusters import build_clusters
    from raytracer_tpu_torch.models.scene import load_scene
    from raytracer_tpu_torch.models.whitted import render_rays
    from raytracer_tpu_torch.ops.camera import camera_vectors, eye_rays_from
    from raytracer_tpu_torch.parallel.train import init_state, make_train_step
    from raytracer_tpu_torch.utils.synth import terrain_scene

    fields = ("mat_diffuse", "light_int", "light_pos", "vertices")
    scenes = {
        "terrain 64x64": terrain_scene(cells=126, res=64, mirror_stripes=True,
                                       device="cpu"),
        "entry": load_scene(os.path.join(REPO, "tests", "data",
                                         "entry_scene.xml"), device="cpu"),
    }
    rows = {}
    for label, (data, meta) in scenes.items():
        cam = meta.cameras[0]
        origin, dirs = eye_rays_from(torch.from_numpy(camera_vectors(cam)),
                                     cam.width, cam.height)
        cset = build_clusters(data, meta, build_bvh(data, meta))
        with torch.no_grad():
            target = render_rays(*moved((data, meta, origin, dirs, cset), dev),
                                 engine="cluster").cpu()
        bad = dataclasses.replace(data, mat_diffuse=data.mat_diffuse * 0.5,
                                  light_int=data.light_int * 0.7)
        for engine in ("brute", "bvh", "cluster"):
            accel = {"brute": None, "cluster": cset,
                     "bvh": device_bvh(build_bvh(data, meta, ordered=True),
                                       "cpu")}[engine]
            got = {}
            for d in (dev, torch.device("cpu")):
                b, o, di, t, acc = moved((bad, origin, dirs, target, accel), d)
                state = init_state(b, fields=fields)
                t0 = time.perf_counter()
                state, loss = make_train_step(meta, engine=engine, device=d)(
                    state, b, o, di, t, accel=acc)
                got[d.type] = (float(loss), {f: p.grad.cpu() for f, p in
                                             state.params.items()},
                               time.perf_counter() - t0)
            (gl, gg, gs), (cl, cg, cs) = got["cuda"], got["cpu"]
            errs = {f: float((gg[f] - cg[f]).abs().max())
                    / max(float(cg[f].abs().max()), 1e-30) for f in fields}
            log(f"  {label} {engine}: loss cuda {gl:.8g} cpu {cl:.8g}; grad "
                f"error / max |g| {errs}; step {gs:.3f} s cuda, {cs:.3f} s cpu")
            check(abs(gl - cl) <= 1e-5 * abs(cl) and math.isfinite(gl),
                  f"{label} {engine}: losses {gl} and {cl}")
            for f in fields:
                check(bool(torch.isfinite(gg[f]).all()) and errs[f] <= 1e-3,
                      f"{label} {engine}: {f} gradient apart by {errs[f]}")
            rows[f"{label} {engine}"] = {"loss_cuda": gl, "loss_cpu": cl,
                                         "grad_err": errs}
    results["train_cuda_vs_cpu"] = rows


def small_vs_cpu(label, data, meta, cset, mode, ssaa, chunk=1 << 22):
    """The scene through a 64x64 camera in ``mode`` on CUDA and on the CPU,
    the jitter drawn on CUDA and replayed on the CPU (where each array must
    equal the CPU's own draw bit for bit): the image bar."""
    import torch

    from raytracer_tpu_torch.models.whitted import render_camera_streamed
    from raytracer_tpu_torch.ops.adaptive import render_camera_adaptive
    from raytracer_tpu_torch.ops.camera import draw_jitter, recorded_jitter
    from raytracer_tpu_torch.ops.image import quantize

    cam = dataclasses.replace(meta.cameras[0], width=64, height=64)
    record, replay = recorded_jitter(7, cset.tri_dat.device)

    def replay_checked(key, shape):
        x = replay(key, shape)
        check(torch.equal(x.cpu(), draw_jitter(None, 7, key, shape, "cpu")),
              f"{label}: the jitter {key} drawn on CUDA is not the CPU's")
        return x

    imgs = {}
    for d, jit, (dd, mm, cc) in (("cuda", record, (data, meta, cset)),
                                 ("cpu", replay_checked, to_cpu(data, meta, cset))):
        if mode == "adaptive":
            col, _ = render_camera_adaptive(dd, mm, cam, cc, base_spp=ssaa * ssaa,
                                            extra_spp=3 * ssaa * ssaa, device=d,
                                            jitter=jit)
            imgs[d] = quantize(col).cpu().numpy()
        else:
            imgs[d] = render_camera_streamed(dd, mm, cam, cc, chunk=chunk,
                                             ssaa=ssaa, ssaa_mode=mode, device=d,
                                             jitter=jit).cpu().numpy()
    compare_images(imgs["cuda"], imgs["cpu"],
                   f"{label} at 64x64 (ssaa {ssaa}, {mode}), cuda vs cpu")


@contextlib.contextmanager
def patched(module, name, wrap):
    """``module.name`` replaced by ``wrap(original)`` inside the block."""
    orig = getattr(module, name)
    setattr(module, name, wrap(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def instrumented(cap):
    """One eager frame's bands, jitter draws and waves, inside ``cap``:
    yields {"bands": ray count of every band program run
    (``whitted._Frame``), "draws": (offsets, ms) of every jitter draw
    (``draw_jitter_into``, in a band's or wave's prologue), device-timed
    (CUDA events around it, queued behind a spin), "late_draws": those
    whose spin ended before the draw was queued (their ms hold a host
    gap), "compactions": activity compactions}; the kernel calls of
    adaptive sampling's refinement waves (its ``_Rays`` of
    ``compact_mode="deep"``) are kept under the tag "@refine", and those
    after a compaction under "@compacted" too."""
    import torch

    from raytracer_tpu_torch.models import whitted
    from raytracer_tpu_torch.ops import adaptive

    seen = {"bands": [], "draws": [], "late_draws": 0, "compactions": 0}

    def band(f):
        def counted(self, *a):
            seen["bands"].append(self.w * self.bh)
            return f(self, *a)
        return counted

    def draw(f):
        def timed(key, out):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            # the host enqueues while the card spins (~8 ms: long enough for
            # a new block of the caching allocator, whose cudaMalloc would
            # otherwise fall between the events)
            torch.cuda._sleep(1 << 24)
            e0.record()
            x = f(key, out)
            late = e0.query()   # the card reached e0 before the draw was queued
            e1.record()
            e1.synchronize()
            seen["draws"].append((out.numel(), e0.elapsed_time(e1)))
            seen["late_draws"] += late
            return x
        return timed

    def wave(f):
        def made(*a, compact_mode="auto", **kw):
            rays = f(*a, compact_mode=compact_mode, **kw)
            run = rays.run

            def tagged():
                cap.tag = "@refine" if compact_mode == "deep" else ""
                try:
                    run()
                finally:
                    cap.tag = ""
            rays.run = tagged
            return rays
        return made

    def compact(f):
        def tagged(carry):
            seen["compactions"] += 1
            if not cap.tag.endswith("@compacted"):
                cap.tag += "@compacted"
            return f(carry)
        return tagged

    def ray_wave(f):
        def untagged(self):
            cap.tag = cap.tag.replace("@compacted", "")
            return f(self)
        return untagged

    with contextlib.ExitStack() as stack:
        for mod, name, wrap in ((whitted._Frame, "__call__", band),
                                (whitted, "draw_jitter_into", draw),
                                (adaptive, "draw_jitter_into", draw),
                                (adaptive, "_Rays", wave),
                                (whitted._Wavefront, "run", ray_wave),
                                (whitted, "_compact_carry", compact)):
            stack.enter_context(patched(mod, name, wrap))
        yield seen


def drive_mode(label, frame, results, key, must, checked, must_not=()):
    """One render mode through ``frame`` (render_one_camera): a warm-up
    frame; one frame with the launch counts reset just before and read
    just after (every kernel of ``must`` launched, none of ``must_not``);
    the same frame eager (equal image and launches), its kernel inputs
    captured and each kernel held against its plain version
    (``checked``), its bands and its jitter draws timed; 3 timed frames
    (median) and their peak device memory; one profiled frame (device
    busy, idle share against the median).  Returns (image, adaptive stats,
    launches)."""
    import numpy as np
    import torch

    from raytracer_tpu_torch.models.whitted import eager
    from raytracer_tpu_torch.ops import kernels as K

    frame()
    torch.cuda.synchronize()
    K.reset_launches()
    img, stats = frame()
    torch.cuda.synchronize()
    launches = dict(K.launches)
    for name in must:
        check(launches[name] > 0, f"{label}: {name} was not launched")
    for name in must_not:
        check(launches[name] == 0, f"{label}: {name} was launched")
    # the same frame eager, its kernel calls, bands and draws recorded
    K.reset_launches()
    with Capture(K) as cap, instrumented(cap) as seen, eager():
        eager_img, _ = frame()
    torch.cuda.synchronize()
    check(dict(K.launches) == launches,
          f"{label}: eager launches {dict(K.launches)}, replayed {launches}")
    check(np.array_equal(eager_img, img), f"{label}: the eager frame differs")
    bands = seen["bands"]
    draw_ms = sum(ms for _, ms in seen["draws"])
    n_draw = sum(n for n, _ in seen["draws"])
    log(f"  {label}: launches {launches}; bands {len(bands)} "
        f"({sorted(set(bands))} rays); compactions {seen['compactions']}; "
        f"jitter draws {draw_ms:.4f} ms of device time for {n_draw} offsets "
        f"({len(seen['draws'])} draws, {seen['late_draws']} queued after "
        "their spin ended)")
    log(f"  {label}: captured calls {sorted(cap.calls)}")
    checked(label, cap.calls)
    del cap
    times = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    ms = statistics.median(times)
    check(stats is not None or bands, f"{label}: neither adaptive nor streamed")
    rays = stats["total_samples"] if stats else sum(bands)
    profile_frame(frame, results, key + "_profile")
    prof = results.get(key + "_profile")
    busy = prof["device_busy_ms"] if prof else None
    idle = 1 - busy / ms if prof else None
    check(img.dtype == np.uint8 and img.max() > 0, f"{label}: empty image")
    log(f"  {label}: frame ms (3 warm runs) {[round(t, 3) for t in times]}; median "
        f"{ms:.3f} ms, {rays / ms / 1e3:.3f} Mrays/s ({rays} primary rays); peak "
        f"{peak} bytes ({peak / 2**30:.3f} GiB); device busy {busy} ms, idle "
        f"share {idle}")
    results[key] = {"ms": ms, "runs_ms": times, "primary_rays": rays,
                    "mrays_per_s": rays / ms / 1e3, "peak_bytes": peak,
                    "launches": launches, "bands": bands, "device_busy_ms": busy,
                    "idle_share": idle, "adaptive": stats, "draw_ms": draw_ms,
                    "late_draws": seen["late_draws"],
                    "draw_offsets": n_draw, "compactions": seen["compactions"]}
    return img, stats, launches


def render_modes(dev, results, full, big, big_res, checked):
    """Phase 6: ``terrain_scene(**full, mirror_stripes=True)`` through
    render_one_camera streamed at --ssaa 4 parity, at --ssaa 2 jitter and
    in adaptive mode (``drive_mode`` each, and each checked at 64x64
    against the CPU); then ``terrain_scene(**big, ...)`` through a
    ``big_res`` camera at --ssaa 2 jitter once with its kernel inputs
    captured and checked, its launch counts (the hierarchical mask and
    any-hit included, no shadow kernel) and bands (each within the
    big-scene cap), and once more for its peak memory and wall time, and
    checked at 64x64 against the CPU.  Returns {path: launches}."""
    import numpy as np
    import torch

    from raytracer_tpu_torch.models import programs
    from raytracer_tpu_torch.models.whitted import _BIG_SCENE_CHUNK, eager
    from raytracer_tpu_torch.ops import kernels as K
    from raytracer_tpu_torch.pipeline import render_one_camera
    from raytracer_tpu_torch.utils.ppm import write_ppm
    from raytracer_tpu_torch.utils.synth import terrain_scene

    data, meta, cset = build(terrain_scene, dev, mirror_stripes=True, **full)
    cam = meta.cameras[0]
    res = cam.width
    modes = {
        "streamed_ssaa4": ("streamed, --ssaa 4 parity", dict(ssaa=4)),
        "jitter_ssaa2": ("--ssaa 2 --ssaa-mode jitter", dict(ssaa=2, ssaa_mode="jitter")),
        "adaptive": ("--ssaa-mode adaptive (base 4 spp, 12.5% of blocks get 12 more)",
                     dict(ssaa=2, ssaa_mode="adaptive")),
    }
    path_launches = {}
    for key, (label, kw) in modes.items():
        def frame(kw=kw):
            return render_one_camera(data, meta, cam, cset, device=dev, **kw)
        img, stats, path_launches[key] = drive_mode(
            f"full-width terrain {label}", frame, results, key,
            must=ENTRY_MUST + (("threefry",) if "ssaa_mode" in kw else ()),
            checked=checked)
        check(img.shape == (res, res, 3), f"{label}: image {img.shape}")
        bands = results[key]["bands"]
        if key == "adaptive":
            check(stats["mean_spp"] == 5.5, f"{label}: stats {stats}")
        else:
            ssaa = kw["ssaa"]
            check(sum(bands) == (res * ssaa) ** 2 and max(bands) <= 1 << 22,
                  f"{label}: bands {bands}")
        write_ppm(os.path.join(OUT, f"terrain_{res}_{key}.ppm"), img)
    small_vs_cpu("full-width terrain", data, meta, cset, "parity", 4, chunk=16384)
    small_vs_cpu("full-width terrain", data, meta, cset, "jitter", 2, chunk=2048)
    small_vs_cpu("full-width terrain", data, meta, cset, "adaptive", 2)
    programs.drop(data)
    del data, cset

    data, meta, cset = build(terrain_scene, dev, mirror_stripes=True, **big)
    cam = dataclasses.replace(meta.cameras[0], width=big_res, height=big_res)

    def frame():
        return render_one_camera(data, meta, cam, cset, ssaa=2,
                                 ssaa_mode="jitter", device=dev)
    frame()
    torch.cuda.synchronize()
    K.reset_launches()
    img, _ = frame()
    torch.cuda.synchronize()
    launches = dict(K.launches)
    K.reset_launches()
    with Capture(K) as cap, instrumented(cap) as seen, eager():
        eager_img, _ = frame()
    torch.cuda.synchronize()
    check(dict(K.launches) == launches and np.array_equal(eager_img, img),
          f"big terrain jitter: the eager frame differs ({dict(K.launches)})")
    bands = seen["bands"]
    path_launches["big_jitter"] = launches
    log(f"  big terrain at {big_res}x{big_res}, --ssaa 2 jitter: launches "
        f"{launches}; bands {bands}; captured calls {sorted(cap.calls)}")
    for name in ("ray_mask", "ray_mask_hier", "closest_shared", "closest", "any",
                 "threefry"):
        check(launches[name] > 0, f"big terrain jitter: {name} was not launched")
    check(launches["shadow"] == 0, "big terrain jitter: shadow was launched")
    check(sum(bands) == (2 * big_res) ** 2 and max(bands) <= _BIG_SCENE_CHUNK,
          f"big terrain jitter: bands {bands}")
    check(img.shape == (big_res, big_res, 3) and img.max() > 0,
          "big terrain jitter: empty image")
    checked(f"big terrain {big_res}x{big_res} jitter", cap.calls)
    del cap
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    frame()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    log(f"  big terrain at {big_res}x{big_res}, --ssaa 2 jitter, fourth frame: "
        f"peak {peak} bytes ({peak / 2**30:.3f} GiB); wall time {wall:.3f} ms "
        "(one frame, not a median)")
    results["big_jitter"] = {"launches": launches, "bands": bands,
                             "peak_bytes": peak, "wall_ms": wall}
    small_vs_cpu("big terrain", data, meta, cset, "jitter", 2)
    programs.drop(data)
    return path_launches


def sm_clock_mhz(fn, args, n):
    """(SM clock, its maximum) in MHz as ``nvidia-smi`` reads them; the
    query starts before the card runs a ~0.27 s spin and then ``n``
    launches of ``fn(*args)``, so the first is read while they run."""
    import torch

    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                            "--format=csv,noheader,nounits"],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        torch.cuda._sleep(1 << 29)
        for _ in range(n):
            fn(*args)
        out, err = smi.communicate(timeout=60)
    finally:
        if smi.poll() is None:
            smi.kill()
            smi.wait()
    torch.cuda.synchronize()
    check(smi.returncode == 0, f"nvidia-smi failed: {err[-500:]}")
    sm, top = (float(x) for x in out.splitlines()[0].split(","))
    return sm, top


def threefry_on_card(dev, results):
    """Phase 6b: the threefry kernel, keyed from device memory
    (``threefry_uniform_keyed``), against its plain version on the same key
    tensor on the card, bit for bit, at the full-width band shape and at
    the full-width adaptive frame's base and round shapes; each draw's
    first and last 8 floats against JAX's (JAX_DRAWS), and the whole draw
    against the host-key call (``threefry_uniform``) on the same key.  The
    band draw timed on the device (20 launches behind a spin) beside the
    plain version and its bound: the card's issue ceiling (phase 1's SASS
    instructions of the kernel per 32 elements over 132 SMs x 4 warp
    instructions a clock at the card's maximum SM clock, or its 4 bytes an
    element at 3.35 TB/s, whichever is longer); the SM clock read while it
    runs and the older bound (88 operations an element at the FP32 rate)
    are logged beside it.  Returns the kernel row's numbers."""
    import numpy as np
    import torch

    from raytracer_tpu_torch.ops import kernels as K
    from raytracer_tpu_torch.ops.camera import jitter_key

    def words(seed, key):
        return torch.tensor(jitter_key(seed, key), dtype=torch.int64,
                            device=dev)

    for seed, key, shape, first, last in JAX_DRAWS:
        n = math.prod(shape)
        key_t = words(seed, key)
        got = K.threefry_uniform_keyed(
            key_t, torch.full(shape, float("nan"), device=dev), -0.5, 0.5)
        want = K.threefry_uniform_keyed_plain(
            key_t, torch.empty(shape, device=dev), -0.5, 0.5)
        host = K.threefry_uniform(*jitter_key(seed, key), n, -0.5, 0.5, dev)
        torch.cuda.synchronize()
        got, want, host = (x.view(-1).view(torch.int32)
                           for x in (got, want, host))
        n_diff = int((got != want).sum())
        check(n_diff == 0, f"threefry {key} of seed {seed} {shape}: {n_diff} of "
              f"{n} floats differ from the plain version")
        check(torch.equal(got, host), f"threefry {key} of seed {seed} {shape}: "
              "the keyed draw is not the host-key call's")
        bits = got.cpu().numpy().view(np.uint32)
        check(bits[:8].tolist() == first and bits[-8:].tolist() == last,
              f"threefry {key} of seed {seed} {shape}: not JAX's draw")
        log(f"  threefry {key} of seed {seed}, {shape} ({n} floats), keyed from "
            "device memory: equal to the plain version and to the host-key "
            "call bit for bit; first and last 8 equal to JAX's")
    seed, key, shape = JAX_DRAWS[0][:3]
    n = math.prod(shape)
    args = (words(seed, key), torch.empty(shape, device=dev), -0.5, 0.5)
    ms = time_call(K.threefry_uniform_keyed, args, 20)
    plain_ms = time_once(K.threefry_uniform_keyed_plain, args)
    sm_mhz, max_mhz = sm_clock_mhz(K.threefry_uniform_keyed, args, 3000)
    instr = results["sass_instructions"]["threefry_uniform"]
    t_issue = n * instr / (132 * 4 * 32 * max_mhz * 1e6) * 1e3
    t_bytes = 4 * n / PEAK_BYTES * 1e3
    t_fp32 = max(n * OPS_THREEFRY / PEAK_FP32 * 1e3, t_bytes)
    row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_issue, t_bytes),
           "bound_by": "operations" if t_issue >= t_bytes else "bytes",
           "elements": n, "sass_instructions": instr, "sm_mhz": sm_mhz,
           "max_sm_mhz": max_mhz, "issue_bound_ms": t_issue,
           "bytes_bound_ms": t_bytes}
    log(f"  threefry, one full-width band draw ({n} floats, keyed): {ms:.4f} "
        f"ms/launch (device); bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}: {instr} SASS instructions a thread over 132 SMs "
        f"x 4 warp instructions a clock at the maximum {max_mhz:.0f} MHz "
        f"= {t_issue:.4f} ms; {4 * n:.3e} bytes = {t_bytes:.4f} ms), "
        f"{row['bound_ms'] / ms:.3f} of the bound; SM clock read while it ran "
        f"{sm_mhz:.0f} MHz; the older bound of {OPS_THREEFRY} ops an element at "
        f"the FP32 rate {t_fp32:.4f} ms; plain {plain_ms:.2f} ms")
    results["threefry"] = row
    return row


def treelet_frame(dev, results, checked):
    """Phase 6c: the full-width terrain on treelet clusters
    (``build_clusters(..., treelet=True)``: padded gaps among the triangle
    slots) at --ssaa 2 through render_one_camera: a warm-up, one frame
    with the launch counts reset just before and read just after (the
    whole frame's kernels launched), the same frame eager with its kernel
    calls held against the plain versions, 3 timed frames (median); at
    64x64 against the CPU.  Returns the frame's launches."""
    import numpy as np
    import torch

    from raytracer_tpu_torch.models import programs
    from raytracer_tpu_torch.models.bvh import build_bvh
    from raytracer_tpu_torch.models.clusters import build_clusters
    from raytracer_tpu_torch.models.whitted import eager
    from raytracer_tpu_torch.ops import cluster_trace as ctr
    from raytracer_tpu_torch.ops import kernels as K
    from raytracer_tpu_torch.pipeline import render_one_camera
    from raytracer_tpu_torch.utils.synth import terrain_scene

    data, meta = terrain_scene(cells=126, res=1024, mirror_stripes=True,
                               device=dev)
    t0 = time.perf_counter()
    cset = build_clusters(data, meta, build_bvh(data, meta), treelet=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    pt = cset.tri_dat.shape[1]
    valid = int((cset.tri_verts != 0).any(0).sum())
    check(valid == meta.n_tris and pt > meta.n_tris,
          f"treelet: {valid} triangle slots of {pt} hold the {meta.n_tris} triangles")
    cam = meta.cameras[0]

    def frame():
        return render_one_camera(data, meta, cam, cset, ssaa=2, device=dev)[0]
    frame()
    torch.cuda.synchronize()
    K.reset_launches()
    img = frame()
    torch.cuda.synchronize()
    launches = dict(K.launches)
    for name in FRAME_MUST:
        check(launches[name] > 0, f"treelet terrain: {name} was not launched")
    check(img.max() > 0, "treelet terrain: empty image")
    K.reset_launches()
    with Capture(K) as cap, eager():
        eager_img = frame()
    torch.cuda.synchronize()
    check(dict(K.launches) == launches and np.array_equal(eager_img, img),
          f"treelet terrain: the eager frame differs ({dict(K.launches)})")
    checked("treelet terrain", cap.calls)
    del cap
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    log(f"  treelet terrain: {pt // 128} triangle clusters ({meta.n_tris} "
        f"triangles in {pt} slots), built in {build_s:.2f} s; launches "
        f"{launches}; frame ms {[round(t, 3) for t in times]}, median {ms:.3f}")
    small_vs_cpu("treelet terrain", data, meta, cset, "parity", 2)
    results["treelet"] = {"clusters": pt // 128, "slots": pt, "build_s": build_s,
                          "launches": launches, "ms": ms, "runs_ms": times}
    programs.drop(data)
    return launches


def example_on_card(results):
    """Phase 7c: examples/inverse_rendering_torch.py on the entry scene (200
    Adam steps on the card over make_mesh()): the loss falls."""
    from raytracer_tpu_torch.ops import kernels as K

    sys.path.insert(0, os.path.join(REPO, "examples"))
    from inverse_rendering_torch import main as example

    xml = os.path.join(REPO, "tests", "data", "entry_scene.xml")
    K.reset_launches()
    t0 = time.perf_counter()
    losses, out = quiet(example, xml, "cluster")
    wall = time.perf_counter() - t0
    launches = dict(K.launches)
    check(len(losses) == 200 and all(math.isfinite(x) for x in losses),
          f"example: losses {losses[:3]}...")
    check(losses[-1] < 0.1 * losses[0], f"example: the loss went from "
          f"{losses[0]} to {losses[-1]}")
    for name in ("ray_mask", "closest", "shadow"):
        check(launches[name] > 0, f"example: {name} was not launched")
    log(f"  example: loss {losses[0]:.6f} -> {losses[-1]:.6f} in 200 steps, "
        f"{wall:.2f} s; launches {launches}; its last lines: "
        + " | ".join(out.splitlines()[-2:]))
    results["example"] = {"losses": losses, "wall_s": wall, "launches": launches}


def _cloned(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        return type(x)(*map(_cloned, x)) if hasattr(x, "_fields") else \
            tuple(map(_cloned, x))
    return x


def epilogue_work(name, args):
    """(float operations, bytes) of one epilogue call: OPS_EPILOGUE over
    its rays, hits and pairs; the bytes the kernel has to move: what it
    reads of every ray, what it reads of a hit ray only (the record past
    the hit flag, the occlusion bits) and of a ray that stops only (its
    own origin), the slot table's rows of the slots hit once each, and
    what it writes."""
    import torch

    from raytracer_tpu_torch.ops import cluster_trace as ctr

    data, meta, cset = args[:3]
    nl, ns = meta.n_lights, ctr._n_small(cset)
    if name == "hit_record":
        t, slot, origin, dirs, active = args[3:]
        r = dirs.shape[0]
        h, mask = ctr.hit_record(*args)
        hit_slots = torch.unique(slot[:r][slot[:r] >= 0])
        ops = r * (OPS_EPILOGUE["ray"] + ns * OPS_EPILOGUE["sphere_pair"]
                   + nl * OPS_EPILOGUE["light"])
        read = nbytes(t[:r], slot[:r], origin, dirs, active) \
            + 32 * hit_slots.numel() + 16 * ns + 12 * nl
        return ops, read + nbytes(*h, mask)
    carry, h, occ = args[3], args[4], args[5]
    r, hits = h.hit.shape[0], int(h.hit.sum())
    ops = hits * (OPS_EPILOGUE["hit"] + nl * OPS_EPILOGUE["hit_light"])
    going = int((carry[2] & h.hit & data.mat_is_mirror[h.mat]).sum())
    org = carry[3]
    read = nbytes(*carry[:3], carry[4], h.hit) \
        + (12 * (r - going) if org.dim() == 2 else nbytes(org)) \
        + hits * nbytes(h.normal[0], h.mat[0], h.offset[0]) \
        + (hits * (nbytes(h.point[0]) + nl) if nl else 0)
    return ops, read + nbytes(*carry[:3], carry[4], carry[4])


def epilogue_on_card(dev, results):
    """Phase 5b: the forward bounce epilogue (csrc/shade.cu) at the busiest
    calls of the horse31k benchmark frame (1440x720 at SSAA 2, 4,147,200
    rays; 2 small spheres, 2 lights): bounce 0's, all rays active.  Each
    kernel equals its plain version there, is timed on the device (10
    launches behind a spin) against its bound and the plain version; its
    device ms and launches in one replayed frame (profiled).  Returns the
    two kernel rows."""
    import torch

    from benchmark import sceneio
    from benchmark.paths import Bench
    from raytracer_tpu_torch.models.scene import from_parsed
    from raytracer_tpu_torch.models.whitted import eager
    from raytracer_tpu_torch.ops import cluster_trace as ctr
    from raytracer_tpu_torch.ops import kernels as K
    from raytracer_tpu_torch.pipeline import render_one_camera
    from raytracer_tpu_torch.render import engine_accel

    bench = Bench(REPO)
    tr = bench.traffic("frame-ssaa2")
    data, meta = from_parsed(
        sceneio.generate(bench, bench.config("horse31k"), 1), dev)
    accel = engine_accel(tr["engine"], None, data, meta, dev)

    def frame():
        return render_one_camera(data, meta, meta.cameras[tr["camera"]], accel,
                                 ssaa=tr["ssaa"], ssaa_mode=tr["ssaa_mode"],
                                 chunk=tr["chunk"], device=dev)[0]

    calls = {"hit_record": [], "shade_bounce": []}

    def keep(name):
        def wrap(f):
            def kept(*a, out=None, **kw):
                calls[name].append(_cloned(a))
                return f(*a, **kw) if out is None else f(*a, out=out, **kw)
            return kept
        return wrap

    with patched(ctr, "hit_record", keep("hit_record")), \
            patched(ctr, "shade_bounce", keep("shade_bounce")), eager():
        frame()
    K.reset_launches()
    frame()                                  # captures
    K.reset_launches()
    frame()                                  # a replay
    launches = dict(K.launches)
    profile_frame(frame, results, "epilogue_profile")
    by_kernel = results.get("epilogue_profile", {}).get("by_kernel", {})
    rows = []
    for name, plain in (("hit_record", ctr.hit_record_plain),
                        ("shade_bounce", ctr.shade_bounce_plain)):
        active = (lambda a: a[7]) if name == "hit_record" else \
            (lambda a: a[3][2])
        args = max(calls[name], key=lambda a: int(active(a).sum()))
        got, want = getattr(ctr, name)(*_cloned(args)), plain(*_cloned(args))
        flat = [x for o in (got, want) for x in
                (o if isinstance(o, tuple) else (o,))]
        flat = [x for o in flat for x in (o if isinstance(o, tuple) else (o,))
                if x is not None]
        half = len(flat) // 2
        check(all(equal_nan(a, b) for a, b in zip(flat[:half], flat[half:])),
              f"{name}: the kernel differs from its plain version at the "
              "horse frame's busiest call")
        ms = time_call(getattr(ctr, name), args, 10)
        plain_ms = time_once(plain, _cloned(args))
        ops, byt = epilogue_work(name, args)
        t_ops, t_bytes = ops / PEAK_ISSUE * 1e3, byt / PEAK_BYTES * 1e3
        dev_ms, n = by_kernel.get(name, [None, 0])
        row = {"name": name, "route": "cuda", "source": SOURCES[name],
               "replaces": REPLACES[name], "launches": launches[name],
               "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "library_ms": None, "ops": ops, "bytes": byt,
               "frames": {"horse31k": {"device_ms": dev_ms, "launches": n}}}
        log(f"  {name} (horse frame's busiest call, {int(active(args).sum())} "
            f"active rays): {ms:.4f} ms/launch, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}: {ops:.3e} ops, {byt:.3e} bytes), "
            f"{row['bound_ms'] / ms:.3f} of the bound, plain {plain_ms:.2f} ms; "
            f"a replayed frame: {launches[name]} launches, device "
            f"{dev_ms if dev_ms is None else round(dev_ms, 4)} ms")
        rows.append(row)
    results["epilogue"] = rows
    return rows


def compact_work(args, out):
    """Bytes the compaction call ``args`` (hit, entry, max_list) has to
    move: every hit byte of its rows, the entry of each hit column, and its
    outputs ``out``."""
    hit, _, _ = args
    return hit.numel() + 4 * int(hit.sum()) + nbytes(*out)


def compact_on_card(dev, results):
    """Phase 5c: the shortlist compaction (csrc/compact.cu) at the busiest
    call (the most hit columns) of the horse31k and terrain524k benchmark
    frames (SSAA 2; the big frame in 32 bands).  At each, the kernel equals
    its plain version (on the CPU: words and counts, ids and entries below
    min(count, max_list)) and is timed on the device (10 launches behind a
    spin) against its byte bound and against the plain version's
    torch.sort route on the card (the library yardstick); its device ms and
    launches in one replayed frame (profiled).  Returns the kernel row."""
    import torch

    from benchmark import sceneio
    from benchmark.paths import Bench
    from raytracer_tpu_torch.models import programs
    from raytracer_tpu_torch.models.scene import from_parsed
    from raytracer_tpu_torch.models.whitted import eager
    from raytracer_tpu_torch.ops import cluster_trace as ctr
    from raytracer_tpu_torch.ops import kernels as K
    from raytracer_tpu_torch.pipeline import render_one_camera
    from raytracer_tpu_torch.render import engine_accel

    bench = Bench(REPO)
    tr = bench.traffic("frame-ssaa2")
    frames = {}
    row = None
    for config in ("horse31k", "terrain524k"):
        data, meta = from_parsed(
            sceneio.generate(bench, bench.config(config), 1), dev)
        accel = engine_accel(tr["engine"], None, data, meta, dev)

        def frame():
            return render_one_camera(
                data, meta, meta.cameras[tr["camera"]], accel, ssaa=tr["ssaa"],
                ssaa_mode=tr["ssaa_mode"], chunk=tr["chunk"], device=dev)[0]

        best = {}

        def keep(f):
            def kept(hit, entry, max_list, tally=None):
                n = int(hit.sum())
                if n > best.get("hits", -1):
                    best.update(hits=n, args=(hit.clone(), entry.clone(),
                                              max_list))
                return f(hit, entry, max_list, tally)
            return kept

        with patched(ctr, "_compact", keep), eager():
            frame()
        frame()                                  # captures
        K.reset_launches()
        frame()                                  # a replay
        launches = K.launches["compact"]
        profile_frame(frame, results, f"compact_profile_{config}")
        by_kernel = results.get(f"compact_profile_{config}", {}).get(
            "by_kernel", {})
        args = best["args"]
        got = K.compact(*args)
        want = K.compact_plain(args[0].cpu(), args[1].cpu(), args[2])
        cnt = torch.clamp(want[3], max=args[2])
        keep_pos = (torch.arange(args[2])[None] < cnt[:, None]).reshape(-1)
        check(torch.equal(got[0].cpu(), want[0])
              and torch.equal(got[3].cpu(), want[3])
              and torch.equal(got[1].cpu()[keep_pos], want[1][keep_pos])
              and torch.equal(got[2].cpu()[keep_pos].view(torch.int32),
                              want[2][keep_pos].view(torch.int32)),
              f"compact: the kernel differs from its plain version at the "
              f"{config} frame's busiest call")
        ms = time_call(K.compact, args, 10)
        library_ms = time_call(K.compact_plain, args, 10)
        plain_ms = time_once(K.compact_plain, args)
        byt = compact_work(args, got)
        bound_ms = byt / PEAK_BYTES * 1e3
        nt, c = args[0].shape
        dev_ms, n = by_kernel.get("compact", [None, 0])
        frames[config] = {"device_ms": dev_ms, "launches": n,
                          "replayed_launches": launches, "ms": ms,
                          "bound_ms": bound_ms, "library_ms": library_ms,
                          "plain_ms": plain_ms, "bytes": byt, "tiles": nt,
                          "columns": c, "hits": best["hits"],
                          "max_list": args[2]}
        log(f"  compact ({config} frame's busiest call: {nt} tiles x {c} "
            f"columns, {best['hits']} hits, max_list {args[2]}): {ms:.4f} "
            f"ms/launch, bound {bound_ms:.4f} ms (bytes: {byt:.3e}), "
            f"{bound_ms / ms:.3f} of the bound; the torch.sort route "
            f"{library_ms:.4f} ms, plain once {plain_ms:.2f} ms; a replayed "
            f"frame: {launches} launches, device "
            f"{dev_ms if dev_ms is None else round(dev_ms, 4)} ms ({n} events)")
        check(launches > 0, f"{config}: the replayed frame launched no compact")
        if row is None:
            row = {"name": "compact", "route": "cuda",
                   "source": SOURCES["compact"], "replaces": REPLACES["compact"],
                   "launches": launches, "max_abs_err": 0.0, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": "bytes", "library_ms": library_ms,
                   "ops": 0, "bytes": byt}
        programs.drop(data)
        del data, accel, best
    row["frames"] = frames
    results["compact"] = row
    return row


def tile_mask_work(args):
    """(ops, bytes) of the interval tile mask call ``args`` (origin, dirs,
    active, cmin, cmax, t_hi, tile, subsplit): every (sub-interval, column)
    pair and every active ray (``OPS_TILE_MASK``); the rays, the boxes and
    the (tiles, C) bool and f32 outputs."""
    origin, dirs, active, cmin, cmax, t_hi, tile, sub = args
    r, c = dirs.shape[0], cmin.shape[0]
    cap = t_hi is not None
    n_act = r if active is None else int(active.sum())
    ops = ((r // tile) * sub * c * (OPS_TILE_MASK["pair"] + cap)
           + n_act * (OPS_TILE_MASK["ray"] + cap))
    byt = (nbytes(origin, dirs, cmin, cmax)
           + (0 if active is None else nbytes(active))
           + (0 if t_hi is None else nbytes(t_hi)) + (r // tile) * c * 5)
    return ops, byt


def tile_mask_on_card(dev, results):
    """Phase 5d: the shared-eye interval tile mask (csrc/tile_mask.cu) at
    the busiest call (the most hits) of the terrain524k benchmark frame (a
    band's bounce 0: 1,024 tiles x 4,096 columns) and of the horse31k frame
    (its one call, 32,400 x 247).  At each, the kernel equals its plain version on the
    card (hit everywhere, entry wherever it is not NaN in both) and is
    timed on the device (10 launches behind a spin) against its bound and
    against the plain version on the card (10 launches, device-timed);
    its launches and device ms in one replayed frame (profiled).  Returns
    the kernel row."""
    import torch

    from benchmark import sceneio
    from benchmark.paths import Bench
    from raytracer_tpu_torch.models import programs
    from raytracer_tpu_torch.models.scene import from_parsed
    from raytracer_tpu_torch.models.whitted import eager
    from raytracer_tpu_torch.ops import cluster_trace as ctr
    from raytracer_tpu_torch.ops import kernels as K
    from raytracer_tpu_torch.pipeline import render_one_camera
    from raytracer_tpu_torch.render import engine_accel

    bench = Bench(REPO)
    tr = bench.traffic("frame-ssaa2")
    frames = {}
    row = None
    for config in ("terrain524k", "horse31k"):
        data, meta = from_parsed(
            sceneio.generate(bench, bench.config(config), 1), dev)
        accel = engine_accel(tr["engine"], None, data, meta, dev)

        def frame():
            return render_one_camera(
                data, meta, meta.cameras[tr["camera"]], accel, ssaa=tr["ssaa"],
                ssaa_mode=tr["ssaa_mode"], chunk=tr["chunk"], device=dev)[0]

        first = {"calls": 0, "hits": -1}

        def keep(f):
            def kept(*a):
                out = f(*a)
                n = int(out[0].sum())
                if n > first["hits"]:
                    first["args"] = tuple(x.clone() if torch.is_tensor(x) else x
                                          for x in a) + (1,) * (8 - len(a))
                    first["hits"] = n
                first["calls"] += 1
                return out
            return kept

        with patched(ctr, "tile_cluster_mask", keep), eager():
            frame()
        frame()                                  # captures
        K.reset_launches()
        frame()                                  # a replay
        launches = K.launches["tile_mask"]
        profile_frame(frame, results, f"tile_mask_profile_{config}")
        by_kernel = results.get(f"tile_mask_profile_{config}", {}).get(
            "by_kernel", {})
        args = first["args"]
        hit, entry = K.tile_mask(*args)
        ph, pe = K.tile_mask_plain(*args)
        check(torch.equal(hit, ph)
              and torch.equal(torch.isnan(entry), torch.isnan(pe))
              and bool(((entry == pe) | torch.isnan(pe)).all()),
              f"tile_mask: the kernel differs from its plain version at the "
              f"{config} frame's busiest call")
        ms = time_call(K.tile_mask, args, 10)
        plain_ms = time_call(K.tile_mask_plain, args, 10)
        ops, byt = tile_mask_work(args)
        t_ops, t_bytes = ops / PEAK_ISSUE * 1e3, byt / PEAK_BYTES * 1e3
        bound_ms = max(t_ops, t_bytes)
        nt, c = hit.shape
        dev_ms, n = by_kernel.get("tile_mask", [None, 0])
        frames[config] = {"device_ms": dev_ms, "launches": n,
                          "replayed_launches": launches,
                          "eager_calls": first["calls"], "ms": ms,
                          "bound_ms": bound_ms, "ops": ops, "bytes": byt,
                          "bound_by": "ops" if t_ops >= t_bytes else "bytes",
                          "plain_ms": plain_ms, "tiles": nt, "columns": c,
                          "hits": int(hit.sum()), "equal": True}
        log(f"  tile_mask ({config} frame's busiest call: {nt} tiles x {c} "
            f"columns, {int(hit.sum())} hits): {ms:.4f} ms/launch, bound "
            f"{bound_ms:.4f} ms ({ops:.3e} ops: {t_ops:.4f} ms; {byt:.3e} "
            f"bytes: {t_bytes:.4f} ms), {bound_ms / ms:.3f} of the bound; "
            f"plain {plain_ms:.4f} ms; equal to the plain version; a replayed "
            f"frame: {launches} launches ({first['calls']} eager calls), "
            f"device {dev_ms if dev_ms is None else round(dev_ms, 4)} ms "
            f"({n} events)")
        check(launches == first["calls"] > 0,
              f"{config}: {launches} tile_mask launches in a replayed frame, "
              f"{first['calls']} calls in an eager one")
        if row is None:
            row = {"name": "tile_mask", "route": "cuda",
                   "source": SOURCES["tile_mask"],
                   "replaces": REPLACES["tile_mask"], "launches": launches,
                   "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": frames[config]["bound_by"],
                   "library_ms": None, "ops": ops, "bytes": byt}
        programs.drop(data)
        del data, accel, first
    row["frames"] = frames
    results["tile_mask"] = row
    return row


# ---------------------------------------------------------------------------
# phase 8: the mesh, two processes, sharded training and the render server
# ---------------------------------------------------------------------------

FRAME_MUST = ("ray_mask", "closest_shared", "closest", "shadow")


def frame_rays(fn):
    """(fn(), the ray count of every mesh shard (``whitted._Shard``)
    traced in it): the shards of each band."""
    from raytracer_tpu_torch.models import whitted

    traced = []

    def count(f):
        def counted(self):
            traced.append(self.src.shape[0])
            return f(self)
        return counted

    with patched(whitted._Shard, "__call__", count):
        return fn(), traced


def profiled(fn, results, key, ms):
    """One profiled run of ``fn`` (``profile_frame``): its device busy ms
    against the unprofiled median ``ms``; returns the idle share."""
    profile_frame(fn, results, key)
    prof = results.get(key)
    if not prof:
        return None
    idle = 1 - prof["device_busy_ms"] / ms
    log(f"  device busy {prof['device_busy_ms']:.3f} ms of the unprofiled "
        f"median {ms:.3f} ms: idle share {idle:.3f}")
    return idle


def timed_frames(fn, n=3):
    """(median ms, each run's ms, peak bytes) of ``n`` synchronized runs."""
    import torch

    times = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times, torch.cuda.max_memory_allocated()


def mesh_on_card(dev, results, checked):
    """Phase 8a: the full-width terrain at --ssaa 2 (4,194,304 rays, one
    band) through render_one_camera on a 2-shard mesh of ``dev``, replayed
    (the mesh band's program, ``whitted._MeshFrame``): a warm-up frame
    (the captures), one frame with the launch counts reset just before and
    read just after (every kernel of phase 3 launched), the same frame
    eager (``whitted.eager()``: equal image and launches, two wavefronts
    of 2,097,152 rays traced, its kernel calls held against the plain
    versions), equal bit for bit to phase 3's single-device image; warm
    ms/frame (median of 3), peak and one profiled frame; eager against
    replayed (``compare_programs``); at 64x64 the terrain and the entry
    scene on the 2-shard mesh against the CPU's 2-shard render (parity and
    jitter at --ssaa 2); the 128x150 terrain, whose last band takes
    virtual rows, replayed twice and eager, against the single-device
    render bit for bit.  Returns the frame's launches."""
    import numpy as np
    import torch

    from raytracer_tpu_torch.models.scene import load_scene
    from raytracer_tpu_torch.models.whitted import eager
    from raytracer_tpu_torch.ops import kernels as K
    from raytracer_tpu_torch.parallel.mesh import make_mesh
    from raytracer_tpu_torch.pipeline import render_one_camera
    from raytracer_tpu_torch.utils.ppm import read_ppm
    from raytracer_tpu_torch.utils.synth import terrain_scene

    ref = read_ppm(os.path.join(OUT, "terrain_1024.ppm"))
    data, meta, cset = build(terrain_scene, dev, cells=126, res=1024,
                             mirror_stripes=True)
    mesh = make_mesh(devices=[dev, dev])
    cam = meta.cameras[0]

    def frame():
        return render_one_camera(data, meta, cam, cset, ssaa=2, device=dev,
                                 mesh=mesh)[0]

    frame()                                  # warm-up: the captures
    torch.cuda.synchronize()
    K.reset_launches()
    img = frame()                            # replays
    torch.cuda.synchronize()
    launches = dict(K.launches)
    # the same frame eager: a replay calls no wrapper and traces no
    # wavefront
    K.reset_launches()
    with Capture(K) as cap, eager():
        eager_img, traced = frame_rays(frame)
    torch.cuda.synchronize()
    log(f"  2-shard frame: launches {launches}; wavefronts traced eagerly "
        f"{traced}")
    check(dict(K.launches) == launches, f"2-shard frame: eager launches "
          f"{dict(K.launches)}, replayed {launches}")
    check(np.array_equal(eager_img, img), "2-shard frame: the eager frame "
          "differs from the replayed one")
    check(traced == [2_097_152, 2_097_152], f"2-shard frame traced {traced}")
    for name in FRAME_MUST:
        check(launches[name] > 0, f"2-shard frame: {name} was not launched")
    n_diff = int((img != ref).any(-1).sum())
    log(f"  2-shard frame vs phase 3's single-device image: {n_diff} pixels "
        "differ")
    check(img.shape == ref.shape and n_diff == 0,
          f"2-shard frame: {n_diff} pixels differ from phase 3's image")
    checked("2-shard full-width frame", cap.calls)
    del cap
    ms, times, peak = timed_frames(frame)
    log(f"  2-shard frame ms (3 warm runs) {[round(t, 3) for t in times]}; "
        f"median {ms:.3f} ms, {4_194_304 / ms / 1e3:.3f} Mrays/s; peak {peak} "
        f"bytes ({peak / 2**30:.3f} GiB); phase 3 single-device median "
        f"{results['frame']['ms']:.3f} ms")
    idle = profiled(frame, results, "mesh_frame_profile", ms)
    results["mesh_frame"] = {"ms": ms, "runs_ms": times, "peak_bytes": peak,
                             "launches": launches, "wavefronts": traced,
                             "idle_share": idle}
    compare_programs("2-shard full-width frame", frame, lambda x: x, results,
                     "mesh_frame")

    cpu_mesh = make_mesh(devices=["cpu", "cpu"])
    entry = build(lambda device: load_scene(
        os.path.join(REPO, "tests", "data", "entry_scene.xml"), device=device),
        dev)
    small = {"terrain": (data, meta, cset), "entry": entry}
    for label, (d, m, c) in small.items():
        cam64 = dataclasses.replace(m.cameras[0], width=64, height=64)
        cd, cm, cc = to_cpu(d, m, c)
        for mode in ("parity", "jitter"):
            a = render_one_camera(d, m, cam64, c, ssaa=2, ssaa_mode=mode,
                                  seed=5, device=dev, mesh=mesh)[0]
            b = render_one_camera(cd, cm, cam64, cc, ssaa=2, ssaa_mode=mode,
                                  seed=5, device="cpu", mesh=cpu_mesh)[0]
            compare_images(a, b, f"{label} 64x64 {mode} on 2 shards, cuda vs cpu")
    # 150 rows: 2 shards make bands of lcm(16, 8 x 2) rows, so the last is
    # padded with 10 virtual rows, mid tile-block
    cam150 = dataclasses.replace(cam, width=128, height=150)
    single = render_one_camera(data, meta, cam150, cset, device=dev)[0]

    def padded():
        return render_one_camera(data, meta, cam150, cset, device=dev,
                                 mesh=mesh)[0]
    with eager():
        eager_padded, traced = frame_rays(padded)
    check(sum(traced) == 160 * 128, f"128x150 on 2 shards traced {traced}")
    for what, img150 in (("eager", eager_padded), ("captured", padded()),
                         ("replayed", padded())):
        check(np.array_equal(single, img150), f"128x150 on 2 shards "
              f"({what}) differs from the single-device render")
    log(f"  128x150 on 2 shards (wavefronts {traced}: 10 virtual rows), "
        "eager, captured and replayed, equals the single-device render bit "
        "for bit")
    return launches


def rank_worker(rank: int, store: str) -> int:
    """One of phase 8b's two processes (``chip_smoke.py --worker RANK
    STORE``): gloo over the file store, both ranks on cuda:0.  Renders its
    half of the full-width frame through render_one_camera, replayed (a
    warm-up with the captures, one frame with the launch counts reset and
    read, the same frame eager with equal image and launches, 3 timed
    frames with each gather timed), holds the image against phase 3's and
    compares eager with replayed (``compare_programs``); then 3 sharded
    training steps on the terrain through a 64x64 camera against the
    one-process step, the two-step program against the eager
    multi-process step (``train_deterministic``: 3 steps at 64x64 bit for
    bit; ``train_spread``: phase 7's problem, each rank 524,288 rays),
    5 timed steps at full size (median of steps 2-5) and eager against
    replayed (``compare_programs``); the ranks' parameters equal.  Writes
    smoke_out/rank<R>.json."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from raytracer_tpu_torch.models import programs
    from raytracer_tpu_torch.models.whitted import eager, render_rays
    from raytracer_tpu_torch.ops import kernels as K
    from raytracer_tpu_torch.ops.camera import camera_vectors, eye_rays_from
    from raytracer_tpu_torch.parallel import distributed
    from raytracer_tpu_torch.parallel.mesh import mesh_from_arg
    from raytracer_tpu_torch.parallel.train import init_state, make_train_step
    from raytracer_tpu_torch.pipeline import render_one_camera
    from raytracer_tpu_torch.utils.ppm import read_ppm
    from raytracer_tpu_torch.utils.synth import terrain_scene

    try:
        distributed.initialize(f"file://{store}", 2, rank)
        mesh = mesh_from_arg("auto", "cuda")
        dev = torch.device("cuda", 0)
        check(dist.get_backend() == "gloo" and mesh.size == 2
              and mesh.devices == (dev,), f"rank {rank}: mesh {mesh}")
        data, meta, cset = build(terrain_scene, dev, cells=126, res=1024,
                                 mirror_stripes=True)
        cam = meta.cameras[0]
        res = {}

        def frame():
            return render_one_camera(data, meta, cam, cset, ssaa=2,
                                     device=dev, mesh=mesh)[0]

        gathers = []

        def timed(f):
            # the gather alone: both ranks' shards traced before the clock
            def gather(local, m=None):
                torch.cuda.synchronize()
                dist.barrier()
                t0 = time.perf_counter()
                out = f(local, m)
                torch.cuda.synchronize()
                gathers.append((time.perf_counter() - t0) * 1e3)
                return out
            return gather

        frame()                              # warm-up: the captures
        dist.barrier()
        K.reset_launches()
        img = frame()                        # replays
        torch.cuda.synchronize()
        launches = dict(K.launches)
        K.reset_launches()
        with eager():
            eager_img, traced = frame_rays(frame)
        torch.cuda.synchronize()
        check(dict(K.launches) == launches, f"rank {rank}: eager launches "
              f"{dict(K.launches)}, replayed {launches}")
        check(np.array_equal(eager_img, img),
              f"rank {rank}: the eager frame differs from the replayed one")
        for name in FRAME_MUST:
            check(launches[name] > 0, f"rank {rank}: {name} was not launched")
        ref = read_ppm(os.path.join(OUT, "terrain_1024.ppm"))
        n_diff = int((img != ref).any(-1).sum())
        check(n_diff == 0, f"rank {rank}: {n_diff} pixels differ from phase 3")
        times = []
        with patched(distributed, "gather_rows", timed):
            for _ in range(3):
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                frame()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        compare_programs(f"rank {rank} full-width frame", frame,
                         lambda x: x, res, "rank_frame")

        # 3 sharded steps on a 64x64 camera against the one-process step
        cam64 = dataclasses.replace(cam, width=64, height=64)
        vec = torch.from_numpy(camera_vectors(cam64)).to(dev)
        origin, dirs = eye_rays_from(vec, 64, 64)
        with torch.no_grad():
            target = render_rays(data, meta, origin, dirs, cset, engine="cluster")
        bad = dataclasses.replace(data, mat_diffuse=data.mat_diffuse * 0.5,
                                  light_int=data.light_int * 0.7)
        fields = ("mat_diffuse", "light_int")
        one = init_state(bad, fields=fields)
        _, one_loss = make_train_step(meta, engine="cluster", device=dev)(
            one, bad, origin, dirs, target, accel=cset)
        state = init_state(bad, fields=fields)
        step = make_train_step(meta, engine="cluster", device=dev, mesh=mesh)
        losses = []
        for _ in range(3):
            state, loss = step(state, bad, origin, dirs, target, accel=cset)
            losses.append(float(loss))
        check(abs(losses[0] - float(one_loss)) <= 1e-5 * abs(float(one_loss)),
              f"rank {rank}: sharded loss {losses[0]}, one process "
              f"{float(one_loss)}")
        flats = [torch.cat([p.detach().flatten()
                            for p in state.params.values()]).cpu()]
        programs.drop(data)
        del data, cset, state, step, one

        # the two-step program against the eager step over both ranks
        flats.append(train_deterministic(dev, res, mesh, f"rank {rank} 64x64"))
        label = f"rank {rank} full-size training (524,288 rays a rank)"
        train_spread(dev, res, mesh, label, "rank_train_spread")
        _, tmeta, tcset, torigin, tdirs, ttarget, tbad = training_setup(dev)
        tstep = make_train_step(tmeta, lr=3e-2, engine="cluster", device=dev,
                                mesh=mesh)
        tstate = init_state(tbad, fields=fields)

        def one_step():
            return tstep(tstate, tbad, torigin, tdirs, ttarget,
                         accel=tcset)[1]
        step_times = []
        for i in range(5):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i == 0:
                K.reset_launches()
            one_step()
            torch.cuda.synchronize()
            if i == 0:
                step_launches = dict(K.launches)
            step_times.append((time.perf_counter() - t0) * 1e3)
        compare_programs(f"rank {rank} full-size training step", one_step,
                         None, res, "rank_step", pools=lambda: [
                             p.progs.pool for p in tstep.programs.values()])
        flats.append(torch.cat([p.detach().flatten()
                                for p in tstate.params.values()]).cpu())
        flat = torch.cat(flats)
        both = [torch.empty_like(flat) for _ in range(2)]
        dist.all_gather(both, flat)
        check(torch.equal(both[0], both[1]),
              f"rank {rank}: parameters differ across the ranks")
        out = {"rank": rank, "traced": traced, "launches": launches,
               "frame_ms": statistics.median(times), "runs_ms": times,
               "gather_ms": gathers, "losses": losses,
               "one_process_loss": float(one_loss),
               "step_ms": statistics.median(step_times[1:]),
               "step_runs_ms": step_times, "step_launches": step_launches,
               "programs": res["programs"]}
        with open(os.path.join(OUT, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.barrier()
        dist.destroy_process_group()
    except Failure as e:
        print(f"FAIL: {e}", file=sys.stderr, flush=True)
        return 1
    print(f"rank {rank}: ok", flush=True)
    return 0


def two_ranks(results):
    """Phase 8b: two processes on the card (``rank_worker``), gloo over a
    file store in smoke_out/ (NCCL refuses two ranks on one card); both
    must exit 0 within 600 s.  Returns rank 0's launches of its frame and
    of its full-size training step."""
    store = os.path.join(OUT, "rank_store")
    for f in [store] + [os.path.join(OUT, f"rank{r}.json") for r in (0, 1)]:
        if os.path.exists(f):
            os.remove(f)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(r), store],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        for line in out.strip().splitlines()[-6:]:
            log(f"  [rank {r}] {line}")
        check(p.returncode == 0, f"rank {r} exited with {p.returncode}")
    ranks = []
    for r in (0, 1):
        with open(os.path.join(OUT, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    for d in ranks:
        log(f"  rank {d['rank']}: wavefronts {d['traced']} (eager), launches "
            f"{d['launches']} (replayed); frame ms "
            f"{[round(t, 3) for t in d['runs_ms']]} (median "
            f"{d['frame_ms']:.3f}); gather ms "
            f"{[round(t, 3) for t in d['gather_ms']]}; image equal to phase "
            f"3's; 64x64 losses {d['losses']} (one process "
            f"{d['one_process_loss']}); full-size step ms "
            f"{[round(t, 3) for t in d['step_runs_ms']]} (median of steps "
            f"2-5 {d['step_ms']:.3f}), launches {d['step_launches']}")
        for key in ("rank_frame", "rank_step"):
            row = d["programs"][key]
            log(f"  rank {d['rank']} {key}: " + "; ".join(
                f"{w} {row[w]['ms']:.3f} ms, busy "
                f"{row[w]['device_busy_ms']:.3f} ms, idle "
                f"{row[w]['idle_share']:.3f}, {row[w]['host_ops']} host ops, "
                f"{row[w]['graph_launches']} graph launches"
                for w in ("eager", "graph")))
    check(ranks[0]["losses"] == ranks[1]["losses"], "the ranks' losses differ")
    results["rank2"] = ranks
    return ranks[0]["launches"], ranks[0]["step_launches"]


def train_on_mesh(dev, results, checked):
    """Phase 8c: phase 7's training problem on a 2-shard mesh of ``dev``
    (one process: the replayed route): 5 steps (the first with its
    launches; a sixth eager with its kernel calls, held against the plain
    versions), the loss falling, every gradient finite; step 1's
    loss within rtol 1e-5 of phase 7's first, its gradients and parameters
    within 1e-3 of each field's max against a one-device step; s/step
    (median of steps 2-5).  Returns the step's launches."""
    import torch

    from raytracer_tpu_torch.ops import kernels as K
    from raytracer_tpu_torch.parallel.mesh import make_mesh
    from raytracer_tpu_torch.parallel.train import init_state, make_train_step

    _, meta, cset, origin, dirs, target, bad = training_setup(dev)
    fields = ("mat_diffuse", "light_int")
    one = init_state(bad, fields=fields)
    one, _ = make_train_step(meta, lr=3e-2, engine="cluster", device=dev)(
        one, bad, origin, dirs, target, accel=cset)
    mesh = make_mesh(devices=[dev, dev])
    step = make_train_step(meta, lr=3e-2, engine="cluster", device=dev,
                           mesh=mesh)
    state = init_state(bad, fields=fields)
    losses, times = [], []
    for i in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:
            K.reset_launches()
        state, loss = step(state, bad, origin, dirs, target, accel=cset)
        torch.cuda.synchronize()
        if i == 0:
            launches = dict(K.launches)
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
        for f, p in state.params.items():
            check(bool(torch.isfinite(p.grad).all()), f"2-shard step {i + 1}: {f} grad")
        if i == 0:
            errs = {}
            for f in fields:
                for what, a, b in (("grad", state.params[f].grad, one.params[f].grad),
                                   ("param", state.params[f].detach(),
                                    one.params[f].detach())):
                    errs[f"{f} {what}"] = float((a - b).abs().max()) / max(
                        float(b.abs().max()), 1e-30)
            log(f"  2-shard step 1 against one device: error / max {errs}")
            for k, e in errs.items():
                check(e <= 1e-3, f"2-shard step 1: {k} apart by {e}")
    phase7 = results["train"]["losses"][0]
    check(abs(losses[0] - phase7) <= 1e-5 * abs(phase7),
          f"2-shard step 1 loss {losses[0]}, phase 7's {phase7}")
    check(losses[-1] < losses[0], f"2-shard training losses {losses}")
    for name in TRAIN_MUST:
        check(launches[name] > 0, f"2-shard step: {name} was not launched")
    s_step = statistics.median(times[1:])

    def one_step():
        nonlocal state
        state, _ = step(state, bad, origin, dirs, target, accel=cset)

    checked("2-shard training step",
            eager_step_calls("2-shard training step", one_step, launches).calls)
    log(f"  2-shard steps: launches {launches}; losses {losses} (phase 7's "
        f"first {phase7}); s/step {[round(t, 4) for t in times]}; median of "
        f"steps 2-5 {s_step:.4f} s (phase 7 {results['train']['s_per_step']:.4f})")
    idle = profiled(one_step, results, "mesh_train_profile", s_step * 1e3)
    results["mesh_train"] = {"losses": losses, "runs_s": times,
                             "s_per_step": s_step, "launches": launches,
                             "step1_err": errs, "idle_share": idle}
    return launches


def write_scene_xml(parsed, path):
    """A CENG477 scene XML of the parsed dict that ``models.scene
    .from_parsed`` takes (1-based ids, lights, materials, meshes)."""
    import numpy as np

    def v(x):
        return " ".join(repr(float(t)) for t in x)

    cams = "".join(
        f'<Camera id="{i + 1}"><Position>{v(c["position"])}</Position>'
        f'<Gaze>{v(c["gaze"])}</Gaze><Up>{v(c["up"])}</Up>'
        f'<NearPlane>{v(c["near_plane"])}</NearPlane>'
        f'<NearDistance>{c["near_distance"]!r}</NearDistance>'
        f'<ImageResolution>{c["width"]} {c["height"]}</ImageResolution>'
        f'<ImageName>{c["image_name"]}</ImageName></Camera>\n'
        for i, c in enumerate(parsed["cameras"]))
    lights = "".join(
        f'<PointLight id="{i + 1}"><Position>{v(p)}</Position>'
        f'<Intensity>{v(q)}</Intensity></PointLight>\n'
        for i, (p, q) in enumerate(parsed["point_lights"]))
    mirror = ' type="mirror"'
    mats = "".join(
        f'<Material id="{i + 1}"{mirror if m["is_mirror"] else ""}>'
        f'<AmbientReflectance>{v(m["ambient"])}</AmbientReflectance>'
        f'<DiffuseReflectance>{v(m["diffuse"])}</DiffuseReflectance>'
        f'<SpecularReflectance>{v(m["specular"])}</SpecularReflectance>'
        f'<MirrorReflectance>{v(m["mirror"])}</MirrorReflectance>'
        f'<PhongExponent>{m["phong"]!r}</PhongExponent></Material>\n'
        for i, m in enumerate(parsed["materials"]))
    verts = "\n".join(v(r) for r in np.asarray(parsed["vertices"]).reshape(-1, 3))
    meshes = "".join(
        f'<Mesh id="{i + 1}"><Material>{mat}</Material><Faces>\n'
        + "\n".join(" ".join(str(int(k)) for k in f) for f in faces)
        + "\n</Faces></Mesh>\n"
        for i, (mat, faces) in enumerate(parsed["meshes"]))
    check(not parsed["triangles"] and not parsed["spheres"],
          "write_scene_xml writes meshes only")
    background = " ".join(str(int(c)) for c in parsed["background"])
    with open(path, "w") as f:
        f.write(
            f'<Scene>\n<BackgroundColor>{background}'
            f'</BackgroundColor>\n<ShadowRayEpsilon>{parsed["shadow_eps"]!r}'
            f'</ShadowRayEpsilon>\n<MaxRecursionDepth>{parsed["max_depth"]}'
            f'</MaxRecursionDepth>\n<Cameras>\n{cams}</Cameras>\n<Lights>\n'
            f'<AmbientLight>{v(parsed["ambient_light"])}</AmbientLight>\n{lights}'
            f'</Lights>\n<Materials>\n{mats}</Materials>\n<VertexData>\n{verts}\n'
            f'</VertexData>\n<Objects>\n{meshes}</Objects>\n</Scene>\n')


class ServerProcess:
    """``python -m raytracer_tpu_torch.serve ARGS`` as a child process,
    asked one JSON line at a time on stdin (or, with ``--port``, over TCP).
    Killed on exit if it is still running."""

    def __init__(self, *args):
        self.t0 = time.perf_counter()
        self.p = subprocess.Popen(
            [sys.executable, "-m", "raytracer_tpu_torch.serve", *args],
            cwd=REPO, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, bufsize=1)
        self.ready = json.loads(self.p.stdout.readline() or "null")
        self.ready_s = time.perf_counter() - self.t0
        check(self.ready and self.ready.get("ready"),
              f"the server did not start: {self.ready}")

    def ask(self, req):
        t0 = time.perf_counter()
        self.p.stdin.write(json.dumps(req) + "\n")
        self.p.stdin.flush()
        line = self.p.stdout.readline()
        check(line, f"the server gave no answer to {req}")
        return json.loads(line), time.perf_counter() - t0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.p.poll() is None:
            self.p.kill()
        self.p.wait()
        for f in (self.p.stdin, self.p.stdout, self.p.stderr):
            f.close()


def tcp_ask(sock_file, req):
    sock_file.write(json.dumps(req) + "\n")
    sock_file.flush()
    line = sock_file.readline()
    check(line, f"no TCP answer to {req}")
    return json.loads(line)


def serve_on_card(dev, results, checked):
    """Phase 8d: the render server.  The full-width terrain written to a
    scene XML in smoke_out/; ``serve --warmup entry_scene.xml`` on stdin:
    ping; the entry scene (ssaa 1) equal bit for bit to phase 2's CLI
    image on CUDA; the terrain XML at ssaa 2 twice, the second from the
    cache, both equal to render_one_camera on the same loaded XML; a bad
    ssaa_mode answered ok: false with the server alive; shutdown, exit 0;
    each request's render_s and Mrays/s.  Then over TCP (--port 0):
    render, a client dropping mid-request, reconnect, ping, shutdown.
    Then the terrain request through an in-process RenderServer with its
    launches (counts reset just before, read just after; the programs
    replayed), and once more eager, its image and launches the same, with
    its kernel calls held against the plain versions.  Returns those
    launches."""
    import socket

    import numpy as np
    import torch

    from raytracer_tpu_torch.models.scene import load_scene
    from raytracer_tpu_torch.models.whitted import eager
    from raytracer_tpu_torch.ops import cluster_trace as ctr
    from raytracer_tpu_torch.ops import kernels as K
    from raytracer_tpu_torch.pipeline import render_one_camera
    from raytracer_tpu_torch.render import engine_accel
    from raytracer_tpu_torch.serve import RenderServer
    from raytracer_tpu_torch.utils import synth
    from raytracer_tpu_torch.utils.ppm import read_ppm

    parsed = []
    with patched(synth, "from_parsed",
                 lambda f: lambda p, d: parsed.append(p) or f(p, d)):
        synth.terrain_scene(cells=126, res=1024, mirror_stripes=True,
                            device="cpu")
    xml = os.path.join(OUT, "terrain_1024.xml")
    write_scene_xml(parsed[0], xml)
    entry_xml = os.path.join(REPO, "tests", "data", "entry_scene.xml")
    data, meta = load_scene(xml, device=dev)
    check(meta.n_tris == 31_752 and meta.n_lights == 2,
          f"the terrain XML loads {meta.n_tris} triangles")
    accel = engine_accel("auto", None, data, meta, dev)
    ref = render_one_camera(data, meta, meta.cameras[0], accel, ssaa=2,
                            device=dev)[0]
    out_dir = os.path.join(OUT, "served")
    served = {}
    with ServerProcess("--warmup", entry_xml, "--device", dev.type) as srv:
        log(f"  server ready in {srv.ready_s:.2f} s (with the warm-up render)")
        r, _ = srv.ask({"cmd": "ping"})
        check(r.get("ok") and "pong" in r, f"ping: {r}")
        r, wall = srv.ask({"scene": entry_xml, "out_dir": out_dir, "id": "entry"})
        check(r.get("ok") and r["id"] == "entry", f"entry request: {r}")
        cli = read_ppm(os.path.join(OUT, "entry_cuda_ssaa1", "entry_scene.ppm"))
        check(np.array_equal(read_ppm(r["images"][0]), cli),
              "the served entry scene differs from the CLI's CUDA image")
        served["entry"] = {"render_s": r["render_s"],
                           "mrays_per_s": r["mrays_per_s"], "wall_s": wall}
        for i in (1, 2):
            r, wall = srv.ask({"scene": xml, "out_dir": out_dir, "ssaa": 2})
            check(r.get("ok"), f"terrain request {i}: {r}")
            check(np.array_equal(read_ppm(r["images"][0]), ref),
                  f"terrain request {i} differs from render_one_camera")
            st, _ = srv.ask({"cmd": "stats"})
            served[f"terrain_{i}"] = {"render_s": r["render_s"],
                                      "mrays_per_s": r["mrays_per_s"],
                                      "wall_s": wall, "stats": st}
        check(served["terrain_2"]["stats"]["scenes_cached"]
              == served["terrain_1"]["stats"]["scenes_cached"] == 2,
              f"the second terrain request was not cached: {served}")
        r, _ = srv.ask({"scene": xml, "out_dir": out_dir, "ssaa": 2,
                        "ssaa_mode": "pairty"})
        check(r.get("ok") is False and "ssaa_mode" in r["error"],
              f"a bad ssaa_mode: {r}")
        r, _ = srv.ask({"cmd": "ping"})
        check(r.get("ok"), "the server died on a bad request")
        r, _ = srv.ask({"cmd": "shutdown"})
        check(r.get("shutdown"), f"shutdown: {r}")
        rc = srv.p.wait(timeout=60)
        check(rc == 0, f"the server exited with {rc}")
        warm = srv.p.stderr.read().strip().splitlines()
    log(f"  served (render_s, Mrays/s, client wall s): " + ", ".join(
        f"{k} {v['render_s']} s {v['mrays_per_s']} Mrays/s {v['wall_s']:.4f} s"
        for k, v in served.items()) + f"; warm-up {warm[-1:]}")
    served["ready_s"] = srv.ready_s

    with ServerProcess("--port", "0", "--device", dev.type) as srv:
        port = srv.ready["port"]
        with socket.create_connection(("127.0.0.1", port), timeout=300) as s, \
                s.makefile("rw", encoding="utf-8") as f:
            r = tcp_ask(f, {"scene": entry_xml, "out_dir": out_dir})
            check(r.get("ok"), f"TCP render: {r}")
        # a client that sends a request and drops before the answer
        with socket.create_connection(("127.0.0.1", port), timeout=300) as s:
            s.sendall((json.dumps({"scene": xml, "out_dir": out_dir,
                                   "ssaa": 2}) + "\n").encode())
            s.shutdown(socket.SHUT_RDWR)
        with socket.create_connection(("127.0.0.1", port), timeout=300) as s, \
                s.makefile("rw", encoding="utf-8") as f:
            check(tcp_ask(f, {"cmd": "ping"}).get("ok"), "TCP ping after a drop")
            check(tcp_ask(f, {"cmd": "shutdown"}).get("shutdown"), "TCP shutdown")
        rc = srv.p.wait(timeout=120)
        check(rc == 0, f"the TCP server exited with {rc}")
    log(f"  TCP (--port 0 bound {port}): render, a dropped client, reconnect, "
        "ping, shutdown: exit 0")

    server = RenderServer(device=dev)
    req = {"scene": xml, "out_dir": out_dir, "ssaa": 2}
    server.handle(req)
    torch.cuda.synchronize()
    K.reset_launches()
    r = server.handle(req)
    torch.cuda.synchronize()
    launches = dict(K.launches)
    check(r.get("ok"), f"in-process request: {r}")
    for name in FRAME_MUST:
        check(launches[name] > 0, f"served frame: {name} was not launched")
    log(f"  in-process served terrain frame: launches {launches}, "
        f"render_s {r['render_s']}")
    replayed = read_ppm(r["images"][0])
    K.reset_launches()
    with Capture(K) as cap, eager():
        r = server.handle(req)
    torch.cuda.synchronize()
    check(r.get("ok") and dict(K.launches) == launches
          and np.array_equal(read_ppm(r["images"][0]), replayed),
          f"served frame: the eager request differs ({dict(K.launches)})")
    checked("served terrain frame", cap.calls)
    del cap
    ms, times, _ = timed_frames(lambda: server.handle(req))
    log(f"  in-process served terrain request ms (3 warm runs) "
        f"{[round(t, 3) for t in times]}; median {ms:.3f} ms")
    idle = profiled(lambda: server.handle(req), results, "served_profile", ms)
    served["in_process"] = {"render_s": r["render_s"], "launches": launches,
                            "ms": ms, "runs_ms": times, "idle_share": idle}
    results["serve"] = served
    return launches


# ---------------------------------------------------------------------------
# phase 9: the compiled programs, eager against replayed
# ---------------------------------------------------------------------------

def scene_pools():
    """The graph memory pools of the scenes' programs."""
    from raytracer_tpu_torch.models import programs

    return [p.pool for p in programs._scenes.values() if p.pool]


def pool_bytes(pools):
    """Bytes of the device segments in the graph memory pools ``pools``
    (``torch.cuda.memory_snapshot``), None where the snapshot does not
    name a segment's pool."""
    import torch

    pools = {tuple(p) for p in pools}
    snap = torch.cuda.memory_snapshot()
    if snap and "segment_pool_id" not in snap[0]:
        return None
    return sum(seg["total_size"] for seg in snap
               if tuple(seg["segment_pool_id"]) in pools)


def lean_profile(frame, lead=0):
    """One run of ``frame`` under torch.profiler: (wall ms, device busy ms,
    the CUDA kernels' device ms, top-level PyTorch ops, graph launches,
    {kernel row: [device events, their device ms]}).  ``lead``: a spin of
    that many cycles runs first inside the window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    frame()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if lead:
            torch.cuda._sleep(lead)
        frame()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = mine = 0.0
    rows = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            ms = ev.time_range.elapsed_us() / 1e3
            busy += ms
            name = kernel_of(ev.name)
            if name is not None:
                mine += ms
                row = rows.setdefault(name, [0, 0.0])
                row[0] += 1
                row[1] += ms
    host = host_side(prof)
    graphs = sum(v[0] for k, v in host["runtime"].items() if "GraphLaunch" in k)
    return wall, busy, mine, host["top_level_ops"], graphs, rows


def raw_profile(frame):
    """``lean_profile``'s numbers for one run of ``frame`` (no warm-up run)
    from the profiler's raw events, without building its event tree
    (minutes for the ~10^6 events of an eager BVH frame on the H100 80GB
    HBM3 at 700.00 W): top-level host ops are the aten ops nested in no
    other host event of their thread."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = mine = 0.0
    rows, host, graphs = {}, {}, 0
    cuda = DeviceType.CUDA
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() == cuda:
            ms = ev.duration_ns() / 1e6
            busy += ms
            kname = kernel_of(name)
            if kname is not None:
                mine += ms
                row = rows.setdefault(kname, [0, 0.0])
                row[0] += 1
                row[1] += ms
            continue
        graphs += "GraphLaunch" in name
        host.setdefault(ev.start_thread_id(), []).append(
            (ev.start_ns(), -ev.end_ns(), name[:6] == "aten::"))
    ops = 0
    for events in host.values():
        events.sort()
        end = None                      # the open top-level event's end
        for start, neg_end, aten in events:
            if end is None or start >= end:
                end = -neg_end
                ops += aten
    return wall, busy, mine, ops, graphs, rows


def compare_programs(label, frame, image, results, key, pools=scene_pools,
                     runs=5, lean=False, eager_runs=None, eager_profile=True):
    """One frame eager (``whitted.eager()``) against its captured programs
    replayed: the first graph call after ``programs.clear()`` (its capture
    ms and the bytes of the pools ``pools()``), the launches, the host's
    flag reads and the BVH walk's iterations of one frame each (launches
    and iterations equal), the images (0 differing pixels), ``runs`` warm
    synced frames of each in turns (median ms), one profiled frame of each
    (device busy, idle share against the median, top-level host ops).
    ``image(out)``: the frame's image as a numpy array; None for a
    training step, whose state each run moves on (its results are checked
    apart).  ``lean`` (an eager frame of seconds): no eager run before the
    first graph call, and the frame of each that gives the image, launches
    and peak is the profiled one (``raw_profile``; 3 runs fewer);
    ``eager_runs``: the eager frame's timed runs, when fewer than
    ``runs``; without ``eager_profile`` (lean only) the eager frame that
    gives the image is timed instead of profiled (its device busy, idle
    share and host ops are then not measured: None)."""
    import numpy as np
    import torch

    from raytracer_tpu_torch import tracing
    from raytracer_tpu_torch.models import programs
    from raytracer_tpu_torch.models.whitted import eager
    from raytracer_tpu_torch.ops import kernels as K
    from raytracer_tpu_torch.ops.traverse import walk_stats

    def eager_frame():
        with eager():
            return frame()

    programs.clear()
    if not lean:
        eager_frame()
    torch.cuda.synchronize()
    s0 = dict(programs.stats)
    capture_s0 = tracing.seconds("program.capture")
    t0 = time.perf_counter()
    frame()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    captures = programs.stats["captures"] - s0["captures"]
    capture_ms = (tracing.seconds("program.capture") - capture_s0) * 1e3
    pool = pool_bytes(pools())
    out, prof = {}, {}
    for name, fn in (("eager", eager_frame), ("graph", frame)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        f0, w0 = programs.stats["flag_reads"], walk_stats["iterations"]
        runs_ms = []
        if lean and (eager_profile or name == "graph"):
            got = []
            prof[name] = raw_profile(lambda fn=fn: got.append(fn()))
            res = got[0]
        else:
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            if lean:
                runs_ms.append((time.perf_counter() - t0) * 1e3)
                prof[name] = (None,) * 6
        img = None if image is None else image(res)
        torch.cuda.synchronize()
        out[name] = {"img": img, "launches": dict(K.launches),
                     "runs_ms": runs_ms,
                     "peak": torch.cuda.max_memory_allocated(),
                     "flag_reads": programs.stats["flag_reads"] - f0,
                     "walk_iterations": walk_stats["iterations"] - w0}
    diff = 0 if image is None else int(
        (out["eager"]["img"] != out["graph"]["img"]).any(-1).sum())
    check(diff == 0, f"{label}: {diff} pixels differ between eager and replayed")
    check(out["eager"]["launches"] == out["graph"]["launches"],
          f"{label}: launches {out['eager']['launches']} eager, "
          f"{out['graph']['launches']} replayed")
    check(out["eager"]["walk_iterations"] == out["graph"]["walk_iterations"],
          f"{label}: walk iterations {out['eager']['walk_iterations']} "
          f"eager, {out['graph']['walk_iterations']} replayed")
    for i in range(runs):
        for name, fn in (("eager", eager_frame), ("graph", frame)):
            if name == "eager" and len(out[name]["runs_ms"]) >= (
                    runs if eager_runs is None else eager_runs):
                continue
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out[name]["runs_ms"].append((time.perf_counter() - t0) * 1e3)
    row = {"differing_pixels": diff, "launches": out["graph"]["launches"],
           "first_call_ms": first_ms, "captures": captures,
           "capture_ms": capture_ms, "pool_bytes": pool}
    for name, fn in (("eager", eager_frame), ("graph", frame)):
        ms = statistics.median(out[name]["runs_ms"])
        wall, busy, mine, ops, graphs, rows = prof.get(name) or lean_profile(fn)
        idle = None if busy is None else 1 - busy / ms
        row[name] = {"ms": ms, "runs_ms": out[name]["runs_ms"],
                     "device_busy_ms": busy, "kernels_ms": mine,
                     "idle_share": idle, "host_ops": ops,
                     "graph_launches": graphs, "profiled_wall_ms": wall,
                     "kernel_events": rows, "peak_bytes": out[name]["peak"],
                     "flag_reads": out[name]["flag_reads"],
                     "walk_iterations": out[name]["walk_iterations"]}
        profiled = ("not profiled" if busy is None else
                    f"device busy {busy:.3f} ms (the CUDA kernels {mine:.3f}), "
                    f"idle share {idle:.3f}; {ops} top-level host ops, "
                    f"{graphs} graph launches, kernel events "
                    + ", ".join(f"{k} {n}x {t:.4f} ms"
                                for k, (n, t) in sorted(rows.items())))
        log(f"  {label}, {name}: {ms:.3f} ms/frame (median of "
            f"{len(out[name]['runs_ms'])} "
            f"{[round(t, 3) for t in out[name]['runs_ms']]}); {profiled}; "
            f"{out[name]['flag_reads']} flag reads, "
            f"{out[name]['walk_iterations']} walk iterations; peak allocated "
            f"{out[name]['peak']} bytes (outside the graph pool)")
    log(f"  {label}: {'0 differing pixels; ' if image is not None else ''}"
        f"launches equal {row['launches']}; "
        f"first graph call {first_ms:.3f} ms with {captures} captures taking "
        f"{capture_ms:.3f} ms; graph pool {pool} bytes")
    results.setdefault("programs", {})[key] = row
    return row


# the replayed step's distance from eager may be at most this many times
# the largest distance between two of 1 + SPREAD_RUNS eager steps from the
# same state (L2 over a field): from one state only the order of
# index_add_'s float atomics differs between two steps, so a field that no
# atomic reaches is equal bit for bit in every eager step and the bar there
# is equality; a stale input or a missed update moves a field by orders of
# magnitude more.  The few materials make the distances heavy-tailed (a
# replayed distance up to 2.6 times the largest of 3 eager ones on the
# H100): the largest of 15 pairs bounds the noise more surely
SPREAD_FACTOR = 4.0
SPREAD_RUNS = 5


def train_spread(dev, results, mesh=None, label="full-width training",
                 key="train_spread", problem=None, engine="cluster", steps=5):
    """Phase 9, training at full width (phase 7's problem, or ``problem``:
    ``training_setup``'s tuple, on ``engine``), replayed against eager (on
    ``mesh`` when given: phase 8b's ranks, each replaying the two-step
    program; results under ``key``, checks named by ``label``).  Eager
    run A takes ``steps`` (5) steps from the start, its state (params,
    Adam's moments and step count) kept before each; the program R takes
    its first 5 steps (the first eager, then captured) from the same start,
    step 1's loss equal to A's bit for bit.  Then, for each step n, R's
    state is loaded with A's state before step n and R replays step n once,
    and an eager state B loaded the same way takes step n ``SPREAD_RUNS``
    times: R's loss and each field's gradient within ``SPREAD_FACTOR``
    times the eager spread (the largest distance between two of A, B_1,
    ..., B_SPREAD_RUNS) of ||R - A|| (equal bit for bit where the eager
    steps are), and R's params, moments and step count
    equal bit for bit what eager Adam makes of R's gradients from that
    state.  Both spreads are printed, and those of a second 5-step eager
    run B against A and of R against A (the atomics' differences carried
    through the later steps).  Loading a state makes no new capture."""
    import contextlib

    import torch

    from raytracer_tpu_torch.models import programs
    from raytracer_tpu_torch.models.whitted import eager
    from raytracer_tpu_torch.parallel.train import init_state, make_train_step

    _, meta, cset, origin, dirs, target, bad = problem or training_setup(dev)
    fields = ("mat_diffuse", "light_int")
    moments = ("step", "exp_avg", "exp_avg_sq")

    def new_run():
        return (make_train_step(meta, lr=3e-2, engine=engine, device=dev,
                                mesh=mesh),
                init_state(bad, fields=fields))

    def one(run, graphs):
        step, state = run
        with contextlib.nullcontext() if graphs else eager():
            loss = step(state, bad, origin, dirs, target, accel=cset)[1]
        return loss.detach().clone(), {
            (f, w): x.detach().clone() for f, p in state.params.items()
            for w, x in (("grad", p.grad), ("param", p))}

    def snapshot(state):
        return ({f: p.detach().clone() for f, p in state.params.items()},
                {f: {m: state.opt.state[p][m].clone() for m in moments}
                 for f, p in state.params.items()})

    def load(state, snap):
        """``snap``'s params and Adam state into ``state`` (which has taken
        a step), in place: a program's graph reads these tensors."""
        params, opt = snap
        with torch.no_grad():
            for f, p in state.params.items():
                p.copy_(params[f])
                for m in moments:
                    state.opt.state[p][m].copy_(opt[f][m])

    def dist(x, y):
        return float(torch.linalg.vector_norm((x - y).double()))

    a_run, b_run, r_run = new_run(), new_run(), new_run()
    a, b, r, before = [], [], [], []
    for _ in range(steps):
        before.append(snapshot(a_run[1]) if a else None)
        a.append(one(a_run, False))
        b.append(one(b_run, False))
        r.append(one(r_run, True))
    # the start: Adam's lazy state is zeros of the kinds step 1 made
    before[0] = ({f: getattr(bad, f).detach().clone() for f in fields},
                 {f: {m: torch.zeros_like(x) for m, x in st.items()}
                  for f, st in snapshot(a_run[1])[1].items()})
    check(torch.equal(r[0][0], a[0][0]), f"{label}: step 1 loss "
          f"{float(r[0][0])!r} replayed, {float(a[0][0])!r} eager")
    trajectory = {f"step {n} {k[0]} {k[1]}": {
        "eager_spread": dist(b[n - 1][1][k], a[n - 1][1][k]),
        "replayed_distance": dist(r[n - 1][1][k], a[n - 1][1][k])}
        for n in sorted({1, steps}) for k in a[0][1]}

    captures = programs.stats["captures"]
    adam = new_run()
    one(adam, False)              # its Adam state made, lr written
    rows = {}
    for n in range(1, steps + 1):
        snap = before[n - 1]
        load(r_run[1], snap)
        loss_r, got_r = one(r_run, True)
        eager_runs = []
        for _ in range(SPREAD_RUNS):
            load(b_run[1], snap)
            eager_runs.append(one(b_run, False))
        loss_a, got_a = a[n - 1]
        keys = [("loss", loss_r, loss_a, [e[0] for e in eager_runs])] + [
            (f"{f} grad", got_r[(f, "grad")], got_a[(f, "grad")],
             [e[1][(f, "grad")] for e in eager_runs]) for f in fields]
        for name, x_r, x_a, x_b in keys:
            xs = [x_a, *x_b]
            spread = max(dist(x, y) for i, x in enumerate(xs)
                         for y in xs[i + 1:])
            d = dist(x_r, x_a)
            rows[f"step {n} {name}"] = {"eager_spread": spread,
                                        "replayed_distance": d}
            check(d <= SPREAD_FACTOR * spread, f"{label} step "
                  f"{n} from eager's state: {name} replayed {d!r} from "
                  f"eager, {1 + SPREAD_RUNS} eager steps up to {spread!r} "
                  f"apart")
        # eager Adam on R's own gradients from the same state
        load(adam[1], snap)
        for f, p in adam[1].params.items():
            p.grad = got_r[(f, "grad")].clone()
        adam[1].opt.step()
        for f, p in r_run[1].params.items():
            q = adam[1].params[f]
            check(torch.equal(p.detach(), q.detach()), f"{label} "
                  f"step {n}: {f} params replayed differ from eager Adam on "
                  f"the replayed gradients")
            for m in moments:
                check(torch.equal(r_run[1].opt.state[p][m],
                                  adam[1].opt.state[q][m]),
                      f"{label} step {n}: {f} Adam {m} replayed "
                      f"differs from eager Adam on the replayed gradients")
    check(programs.stats["captures"] == captures, f"{label}: a "
          "loaded state captured the step anew")
    log(f"  {label} from eager's state before each step, the "
        f"largest distance between {1 + SPREAD_RUNS} eager steps and "
        "||R - A||: " + "; ".join(
            f"{k} {v['eager_spread']:.6g} / {v['replayed_distance']:.6g}"
            for k, v in rows.items())
        + "; params, moments and step count equal to eager Adam on the "
        "replayed gradients")
    log(f"  {label} over {steps} free steps, ||B - A|| (two eager runs) "
        "and ||R - A|| (replayed): " + "; ".join(
            f"{k} {v['eager_spread']:.6g} / {v['replayed_distance']:.6g}"
            for k, v in trajectory.items()))
    log(f"  losses eager A {[float(x[0]) for x in a]}, B "
        f"{[float(x[0]) for x in b]}, replayed {[float(x[0]) for x in r]}")
    results.setdefault("programs", {})[key] = {
        "same_state": rows, "trajectory": trajectory}


def train_deterministic(dev, results, mesh=None, label="64x64",
                        engine="cluster", scene=None, key="train_deterministic"):
    """Phase 9, training on a 64x64 camera of the full-width terrain (or of
    ``scene``: (data, meta, accel)) on ``engine`` under
    ``torch.use_deterministic_algorithms(True)``: 3 steps eager and 3
    replayed from the same start (mat_diffuse, light_int, light_pos and
    vertices), loss, gradients and parameters equal bit for bit, the
    launches of each step equal.  ``mesh``: phase 8b's ranks, each
    replaying the two-step program.  Results under ``key``.  Returns the
    replayed run's last parameters, flat on the host."""
    import contextlib

    import torch

    from raytracer_tpu_torch.models import programs
    from raytracer_tpu_torch.models.whitted import eager, render_rays
    from raytracer_tpu_torch.ops import kernels as K
    from raytracer_tpu_torch.ops.camera import camera_vectors, eye_rays_from
    from raytracer_tpu_torch.parallel.train import init_state, make_train_step
    from raytracer_tpu_torch.utils.synth import terrain_scene

    data, meta, cset = scene or build(terrain_scene, dev, cells=126, res=64,
                                      mirror_stripes=True)
    cam = dataclasses.replace(meta.cameras[0], width=64, height=64)
    origin, dirs = eye_rays_from(torch.from_numpy(camera_vectors(cam)).to(dev),
                                 cam.width, cam.height)
    with torch.no_grad():
        target = render_rays(data, meta, origin, dirs, cset, engine=engine)
    bad = dataclasses.replace(data, mat_diffuse=data.mat_diffuse * 0.5,
                              light_int=data.light_int * 0.7)
    fields = ("mat_diffuse", "light_int", "light_pos", "vertices")
    runs = {}
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for graphs in (False, True):
            step = make_train_step(meta, engine=engine, device=dev,
                                   mesh=mesh)
            state = init_state(bad, fields=fields)
            c0 = programs.stats["captures"]
            got = []
            with contextlib.nullcontext() if graphs else eager():
                for _ in range(3):
                    K.reset_launches()
                    try:
                        state, loss = step(state, bad, origin, dirs, target,
                                           accel=cset)
                    except RuntimeError as e:
                        check(False, f"{label} training step under "
                              f"deterministic algorithms: {e}")
                    torch.cuda.synchronize()
                    got.append((loss, {(f, w): x.detach().clone()
                                       for f, p in state.params.items()
                                       for w, x in (("grad", p.grad),
                                                    ("param", p))},
                                dict(K.launches)))
            # the two-step program over several processes; the BVH
            # engine's visibility pass captures steps of its own
            n = 2 if mesh is not None and mesh.world > 1 else 1
            made = programs.stats["captures"] - c0
            check(made > n if engine == "bvh" and graphs else made == n * graphs,
                  f"{label} deterministic training: {made} captures")
            runs[graphs] = got
    finally:
        torch.use_deterministic_algorithms(was)
    # equal values, NaN where the other has NaN: a grazing sphere hit can
    # give a NaN gradient (sqrt at a clamped discriminant), the same in both
    nans = []
    for i, (e, g) in enumerate(zip(runs[False], runs[True])):
        check(torch.equal(e[0], g[0]), f"{label} deterministic step {i + 1}: "
              f"loss {float(e[0])!r} eager, {float(g[0])!r} replayed")
        for k in e[1]:
            check(e[1][k].shape == g[1][k].shape
                  and equal_nan(e[1][k], g[1][k]),
                  f"{label} deterministic step {i + 1}: {k} differs")
        nans.append({f"{f} {w}": n for (f, w), x in g[1].items()
                     if (n := int(torch.isnan(x).sum()))})
        check(e[2] == g[2], f"{label} deterministic step {i + 1}: launches "
              f"{e[2]} eager, {g[2]} replayed")
    log(f"  {label} training under deterministic algorithms: 3 steps eager and "
        f"replayed equal bit for bit (losses {[float(x[0]) for x in runs[True]]}; "
        f"NaN entries a step {nans}; launches a step {runs[True][0][2]})")
    results.setdefault("programs", {})[key] = {
        "losses": [float(x[0]) for x in runs[True]], "nans": nans,
        "launches": runs[True][0][2]}
    return torch.cat([x.flatten() for (f, w), x in runs[True][-1][1].items()
                      if w == "param"]).cpu()


def train_programs(dev, results):
    """Phase 9's training step: ``train_spread`` and ``train_deterministic``,
    then phase 7's step eager against replayed (``compare_programs`` on
    one state, the runs alternating; the step's own graph pool)."""
    from raytracer_tpu_torch.parallel.train import init_state, make_train_step

    train_spread(dev, results)
    train_deterministic(dev, results)
    _, meta, cset, origin, dirs, target, bad = training_setup(dev)
    step = make_train_step(meta, lr=3e-2, engine="cluster", device=dev)
    state = init_state(bad, fields=("mat_diffuse", "light_int"))

    def one():
        return step(state, bad, origin, dirs, target, accel=cset)[1]
    compare_programs("full-width training step (1,048,576 rays)", one, None,
                     results, "train_step", pools=lambda: [
                         p.progs.pool for p in step.programs.values()])


def programs_on_card(dev, results):
    """Phase 9: the compiled programs (``models.programs``) against the same
    bodies run eagerly (``compare_programs``) on the full-width terrain at
    --ssaa 2, streamed at --ssaa 4 and in jitter mode (one band and 4),
    adaptive (and through a 64x64 camera), the big terrain at --ssaa 2,
    and a warm served terrain request in process; the threefry draw's
    launches, device events and ms in each replayed jitter and adaptive
    frame's profile; then how often the profiler lists the draw: 5
    profiled jitter frames and 5 draws alone, each with no kernel first
    and with a 2**26-cycle spin (~34 ms)."""
    from raytracer_tpu_torch.models import programs
    from raytracer_tpu_torch.pipeline import render_one_camera
    from raytracer_tpu_torch.serve import RenderServer
    from raytracer_tpu_torch.utils.ppm import read_ppm
    from raytracer_tpu_torch.utils.synth import terrain_scene

    data, meta, cset = build(terrain_scene, dev, cells=126, res=1024,
                             mirror_stripes=True)
    cam = meta.cameras[0]
    first = lambda out: out[0]  # noqa: E731
    frames = {}
    for key, label, kw in (
            ("full_width", "full-width terrain, --ssaa 2", dict(ssaa=2)),
            ("streamed_ssaa4", "full-width terrain streamed, --ssaa 4",
             dict(ssaa=4)),
            ("jitter_ssaa2", "full-width terrain, --ssaa 2 jitter",
             dict(ssaa=2, ssaa_mode="jitter")),
            ("jitter_4band", "full-width terrain, --ssaa 2 jitter in 4 bands",
             dict(ssaa=2, ssaa_mode="jitter", chunk=1 << 20))):
        frames[key] = lambda kw=kw: render_one_camera(
            data, meta, cam, cset, device=dev, **kw)
        compare_programs(label, frames[key], first, results, key)
    check(results["programs"]["jitter_4band"]["launches"]["threefry"] == 4,
          "the 4-band jitter frame did not draw once a band")
    small = dataclasses.replace(cam, width=64, height=64)
    for key, label, c in (
            ("adaptive", "full-width terrain, adaptive (base 4 spp, 12.5% of "
             "blocks get 12 more)", cam),
            ("adaptive_64", "full-width terrain through a 64x64 camera, "
             "adaptive", small)):
        frames[key] = lambda c=c: render_one_camera(
            data, meta, c, cset, device=dev, ssaa=2, ssaa_mode="adaptive")
        compare_programs(label, frames[key], first, results, key)
    # the draw inside the replayed graphs, from each frame's profile above:
    # its ms only when the profile lists every launch (it can miss the
    # first draw of a window; the probe below)
    draw = {}
    for key in ("jitter_ssaa2", "jitter_4band", "adaptive", "adaptive_64"):
        row = results["programs"][key]
        n, ms = row["graph"]["kernel_events"].get("threefry", [0, 0.0])
        launched = row["launches"]["threefry"]
        draw[key] = {"launches": launched, "events": n,
                     "ms": ms if n >= launched else None}
        log(f"  {key}, replayed: the threefry draw {launched} launches, "
            f"{n} device events in the profiled frame, "
            + (f"{ms:.4f} ms" if n >= launched else "its ms not measured")
            + f"; {row['graph']['host_ops']} top-level host ops, "
            f"{row['graph']['graph_launches']} graph launches")
    results["programs"]["draw_in_graphs"] = draw
    from raytracer_tpu_torch.ops.camera import draw_jitter

    def bare_draw():
        return draw_jitter(None, 0, ("band", 0), (2048, 2048, 2), dev)
    seen = {}
    for what, fn in (("frame", frames["jitter_ssaa2"]), ("draw alone", bare_draw)):
        for after, lead in (("", 0), (" after a 2**26-cycle spin", 1 << 26)):
            seen[what + after] = [
                lean_profile(fn, lead=lead)[5].get("threefry", [0])[0]
                for _ in range(5)]
    log(f"  threefry device events in 5 profiled runs each (one draw a run): "
        f"{seen}")
    results.setdefault("programs", {})["draw_events"] = seen
    programs.clear()
    del data, cset
    train_programs(dev, results)

    data, meta, cset = build(terrain_scene, dev, cells=512, res=1024,
                             mirror_stripes=True)
    compare_programs("big terrain, --ssaa 2", lambda: render_one_camera(
        data, meta, meta.cameras[0], cset, device=dev, ssaa=2), first,
        results, "big")
    programs.clear()
    del data, cset

    xml = os.path.join(OUT, "terrain_1024.xml")
    check(os.path.exists(xml), "phase 8d's terrain XML is missing")
    server = RenderServer(device=dev)
    req = {"scene": xml, "out_dir": os.path.join(OUT, "programs"), "ssaa": 2}
    check(server.handle(req).get("ok"), "served terrain request")

    def served():
        r = server.handle(req)
        check(r.get("ok"), f"served terrain request: {r}")
        return r
    compare_programs("served terrain request (warm), --ssaa 2", served,
                     lambda r: read_ppm(r["images"][0]), results, "served")
    programs.clear()


# ---------------------------------------------------------------------------
# phase 10: the brute and BVH engines' programs, eager against replayed
# ---------------------------------------------------------------------------

# the BVH frames' camera side (262,144 rays a frame at --ssaa 1), the
# camera side of the other modes and of the served request, the larger
# training camera (65,536 rays a step), and the steps of its spread bar
BVH_SIDE = 512
MODES_SIDE = 256
TRAIN_SIDE = 256
ENGINE_SPREAD_STEPS = 1
# timed runs of each phase-10 frame and step (median), eager and replayed;
# the BVH modes beyond the camera frame and the 64x64 step time their
# eager frame once and do not profile it (an eager BVH frame took 3.0 to
# 8.1 s, host-bound, on the H100 80GB HBM3 at 700.00 W)
ENGINE_RUNS = 3


def engine_compare(full=True):
    """``compare_programs``' options in phase 10: ENGINE_RUNS timed runs
    and the lean schedule (an eager BVH frame takes seconds and runs
    ~10^5 host ops: profiling one cost ~10 s more on the H100 80GB HBM3
    at 700.00 W); not ``full``: the eager frame is timed once and not
    profiled."""
    return dict(runs=ENGINE_RUNS, lean=True, eager_runs=None if full else 1,
                eager_profile=full)


def mirror_spheres(dev):
    """(data, meta) of the 64-sphere field (the scenes that ``auto``
    renders by brute force: at most 64 primitives) at 1024x1024, every
    sphere a mirror (tint 0.8), max depth 2."""
    import torch

    from raytracer_tpu_torch.models.whitted import resolve_engine
    from raytracer_tpu_torch.utils.synth import sphere_field

    data, meta = sphere_field(n_spheres=64, res=1024, device=dev)
    data = dataclasses.replace(
        data, mat_is_mirror=torch.ones_like(data.mat_is_mirror),
        mat_mirror=torch.full_like(data.mat_mirror, 0.8))
    check(resolve_engine("auto", None, meta) == "brute"
          and meta.n_spheres == 64, "the sphere field is not auto's brute case")
    return data, meta


def engine_problem(data, meta, accel, engine, side):
    """``training_setup``'s tuple for ``engine`` on (data, meta, accel)
    through a side x side camera: raster eye rays, the target the true
    scene's radiance, the start with mat_diffuse x 0.5 and light_int x
    0.7."""
    import torch

    from raytracer_tpu_torch.models.whitted import render_rays
    from raytracer_tpu_torch.ops.camera import camera_vectors, eye_rays_from

    cam = dataclasses.replace(meta.cameras[0], width=side, height=side)
    vec = torch.from_numpy(camera_vectors(cam)).to(data.vertices.device)
    origin, dirs = eye_rays_from(vec, side, side)
    with torch.no_grad():
        target = render_rays(data, meta, origin, dirs, accel, engine=engine)
    bad = dataclasses.replace(data, mat_diffuse=data.mat_diffuse * 0.5,
                              light_int=data.light_int * 0.7)
    return data, meta, accel, origin, dirs, target, bad


def engine_training(dev, results, engine, scene, label):
    """Phase 10's training on ``engine`` over ``scene`` (data, meta,
    accel): 3 steps eager and replayed bit for bit at 64x64 under
    deterministic algorithms, the spread bar at TRAIN_SIDE, and the step
    at both sizes eager against replayed (``compare_programs``)."""
    from raytracer_tpu_torch.parallel.train import init_state, make_train_step

    train_deterministic(dev, results, label=f"{label} 64x64", engine=engine,
                        scene=scene, key=f"{engine}_train_deterministic")
    big = engine_problem(*scene, engine, TRAIN_SIDE)
    train_spread(dev, results, label=f"{label} {TRAIN_SIDE}x{TRAIN_SIDE} "
                 "training", key=f"{engine}_train_spread", problem=big,
                 engine=engine, steps=ENGINE_SPREAD_STEPS)
    for side, problem in ((64, engine_problem(*scene, engine, 64)),
                          (TRAIN_SIDE, big)):
        data, meta, accel, origin, dirs, target, bad = problem
        step = make_train_step(meta, lr=3e-2, engine=engine, device=dev)
        state = init_state(bad, fields=("mat_diffuse", "light_int"))

        def one():
            return step(state, bad, origin, dirs, target, accel=accel)[1]
        compare_programs(f"{label} training step {side}x{side} "
                         f"({side * side} rays)", one, None, results,
                         f"{engine}_train_step_{side}",
                         **engine_compare(full=side == TRAIN_SIDE),
                         pools=lambda: [p.progs.pool
                                        for p in step.programs.values()])


def engine_programs(dev, results):
    """Phase 10: the brute and BVH engines' programs against the same
    bodies run eagerly (``compare_programs``: 0 differing pixels, equal
    launches and walk iterations, ms, device busy and idle share, host
    ops, graph launches, flag reads, captures, pool bytes).  BVH: the
    full-width terrain (31,752 triangles, 2 lights, max depth 2) with its
    octant threads (``render.engine_accel``), the camera at
    BVH_SIDE x BVH_SIDE, then at MODES_SIDE streamed at --ssaa 4, jitter,
    adaptive, a band on a 2-shard mesh of the card and a served
    ``--engine bvh`` request; brute: the 64-sphere mirror field at
    1024x1024 --ssaa 2 (4,194,304 rays) and the entry scene; then each
    engine's training step (``engine_training``)."""
    import torch

    from raytracer_tpu_torch.models import programs
    from raytracer_tpu_torch.models.scene import load_scene
    from raytracer_tpu_torch.models.whitted import render_camera
    from raytracer_tpu_torch.parallel.mesh import make_mesh
    from raytracer_tpu_torch.pipeline import render_one_camera
    from raytracer_tpu_torch.render import engine_accel
    from raytracer_tpu_torch.serve import RenderServer
    from raytracer_tpu_torch.utils.ppm import read_ppm
    from raytracer_tpu_torch.utils.synth import terrain_scene

    first = lambda out: out[0]  # noqa: E731
    data, meta = terrain_scene(cells=126, res=1024, mirror_stripes=True,
                               device=dev)
    check(meta.n_tris == 31_752 and meta.n_lights == 2
          and meta.max_depth == 2, "the full-width terrain changed")
    t0 = time.perf_counter()
    bvh = engine_accel("bvh", None, data, meta, dev)
    check(bvh.blocks == 8, "the terrain's BVH has no octant threads")
    log(f"  BVH with octant threads: {bvh.n_nodes} nodes a thread, built in "
        f"{time.perf_counter() - t0:.2f} s")
    cam = dataclasses.replace(meta.cameras[0], width=BVH_SIDE,
                              height=BVH_SIDE)
    compare_programs(f"BVH terrain camera {BVH_SIDE}x{BVH_SIDE} (radiance)",
                     lambda: render_camera(data, meta, cam, bvh, device=dev,
                                           engine="bvh"),
                     lambda x: x.cpu().numpy(), results, "bvh_camera",
                     **engine_compare())
    small = dataclasses.replace(cam, width=MODES_SIDE, height=MODES_SIDE)
    for key, label, kw in (
            ("bvh_streamed_ssaa4", "streamed, --ssaa 4", dict(ssaa=4)),
            ("bvh_jitter", "--ssaa 2 jitter", dict(ssaa=2,
                                                   ssaa_mode="jitter")),
            ("bvh_adaptive", "adaptive (base 4 spp, 12.5% of blocks get 12 "
             "more)", dict(ssaa=2, ssaa_mode="adaptive")),
            ("bvh_mesh2", "--ssaa 2 on a 2-shard mesh of the card",
             dict(ssaa=2, mesh=make_mesh(devices=[dev, dev])))):
        compare_programs(
            f"BVH terrain {MODES_SIDE}x{MODES_SIDE} {label}",
            lambda kw=kw: render_one_camera(data, meta, small, bvh,
                                            device=dev, engine="bvh", **kw),
            first, results, key, **engine_compare(full=False))
    programs.clear()

    xml = os.path.join(OUT, "terrain_1024.xml")
    check(os.path.exists(xml), "phase 8d's terrain XML is missing")
    with open(xml) as f:
        text = f.read()
    res = "<ImageResolution>1024 1024</ImageResolution>"
    check(text.count(res) == 1, "the terrain XML's camera changed")
    xml = os.path.join(OUT, f"terrain_{MODES_SIDE}.xml")
    with open(xml, "w") as f:
        f.write(text.replace(res, f"<ImageResolution>{MODES_SIDE} "
                             f"{MODES_SIDE}</ImageResolution>"))
    server = RenderServer(device=dev)
    req = {"scene": xml, "out_dir": os.path.join(OUT, "engine_served"),
           "engine": "bvh"}

    def served():
        r = server.handle(req)
        check(r.get("ok"), f"served --engine bvh request: {r}")
        return r
    served()
    compare_programs(f"served --engine bvh terrain request (warm), "
                     f"{MODES_SIDE}x{MODES_SIDE}", served,
                     lambda r: read_ppm(r["images"][0]), results,
                     "bvh_served", **engine_compare(full=False))
    programs.clear()
    del server

    sd, sm = mirror_spheres(dev)
    compare_programs("brute 64-sphere mirror field, 1024x1024 --ssaa 2 "
                     "(--engine auto)",
                     lambda: render_one_camera(sd, sm, sm.cameras[0], None,
                                               device=dev, ssaa=2),
                     first, results, "brute_spheres", **engine_compare())
    entry = os.path.join(REPO, "tests", "data", "entry_scene.xml")
    ed, em = load_scene(entry, device=dev)
    compare_programs("brute entry scene, --ssaa 2",
                     lambda: render_one_camera(ed, em, em.cameras[0], None,
                                               device=dev, ssaa=2,
                                               engine="brute"),
                     first, results, "brute_entry", **engine_compare())
    programs.clear()

    engine_training(dev, results, "bvh", (data, meta, bvh), "BVH terrain")
    engine_training(dev, results, "brute", (sd, sm, None),
                    "brute 64-sphere field")
    programs.clear()
    log(f"  card: {smi_line()}")


def scaling_on_card(dev, results):
    """Phase 8e: measure_scaling of the full-width terrain's 4,194,304 eye
    rays (tile order) over [cuda:0] and 2 logical shards of it, replayed:
    run twice, the second run captures nothing (its points are the ones
    kept)."""
    import torch

    from raytracer_tpu_torch.models import programs
    from raytracer_tpu_torch.models.whitted import _tile_order
    from raytracer_tpu_torch.ops.camera import camera_vectors, eye_rays_from
    from raytracer_tpu_torch.ops.tiling import apply_tile_order
    from raytracer_tpu_torch.parallel.scaling import measure_scaling
    from raytracer_tpu_torch.utils.synth import terrain_scene

    data, meta, cset = build(terrain_scene, dev, cells=126, res=1024,
                             mirror_stripes=True)
    cam = meta.cameras[0].scaled(2)
    origin, dirs = eye_rays_from(torch.from_numpy(camera_vectors(cam)).to(dev),
                                 cam.width, cam.height)
    blocks, perm, _ = _tile_order(cam.height, cam.width, dev)
    dirs = apply_tile_order(dirs, cam.height, cam.width, blocks, perm).contiguous()
    first = measure_scaling(data, meta, origin, dirs, cset, "cluster",
                            sizes=[1, 2], device=dev)
    c0 = programs.stats["captures"]
    points = measure_scaling(data, meta, origin, dirs, cset, "cluster",
                             sizes=[1, 2], device=dev)
    check(programs.stats["captures"] == c0,
          "measure_scaling captured again on its second run")
    log("  first run (with the captures): " + ", ".join(
        f"{p.n_devices} shard(s) {p.seconds_per_frame * 1e3:.3f} ms/frame"
        for p in first) + "; the second run replays only")
    for p in points:
        log(f"  {p.n_devices} logical shard(s) on one card: "
            f"{p.rays_per_s / 1e6:.3f} Mrays/s, {p.seconds_per_frame * 1e3:.3f} "
            f"ms/frame, efficiency {p.efficiency:.3f} (the split, not scaling)")
    results["scaling"] = [dataclasses.asdict(p) for p in points]
    programs.drop(data)


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
    from raytracer_tpu_torch.models import programs
    from raytracer_tpu_torch.models.whitted import eager
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
    results["build_s"] = backend.build_seconds()
    results["ptxas"] = ptxas_report(os.path.join(backend.BUILD_DIR, "build.log"))
    for name, row in results["ptxas"].items():
        log(f"  {name}: {row}")
    results["fmnmx"], results["sass_instructions"] = sass_report(
        backend.library_path())
    log("  SASS FMNMX .NAN / other per instance: "
        + ", ".join(f"{n} {v[0]}/{v[1]}" for n, v in results["fmnmx"].items()))
    log("  SASS instructions per instance (to the last EXIT, no NOPs): "
        + ", ".join(f"{n} {v}" for n, v in results["sass_instructions"].items()))

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
    entry_cli_outputs(xml, results)
    entry_engines(xml, results)
    entry_train_cli(xml, results)

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
    cap, small_cap, launches = drive_path(
        "terrain_1024", data, meta, cset, results, "frame",
        must=("ray_mask", "closest_shared", "closest", "shadow"))
    programs.drop(data)
    del data, cset

    # -- phase 3b: big scene, plane tables over the budget
    log("== phase 3b: big terrain (cells=512, res=1024, mirrors) at --ssaa 2")
    from raytracer_tpu_torch.ops import cluster_trace as ctr

    t0 = time.perf_counter()
    data, meta, cset = build(terrain_scene, dev, cells=512, res=1024,
                             mirror_stripes=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    pt, ct = cset.tri_dat.shape[1], cset.tri_dat.shape[1] // 128
    n_super = -(-ct // 128)
    log(f"  scene: {meta.n_tris} triangles, C={ct} clusters, Pt={pt}, "
        f"S={n_super} superclusters, {meta.n_lights} lights, max_depth "
        f"{meta.max_depth}; BVH + clusters built in {build_s:.2f} s")
    check(pt * 64 > ctr.SHADOW_PLANES_BYTES_MAX
          and n_super * 128 > ctr.SUPER_MIN_CPAD,
          "the big terrain does not take the big-scene route")
    results["big_scene"] = {"n_tris": meta.n_tris, "pt": pt, "c": ct,
                            "s": n_super, "build_s": build_s}
    bcap, bsmall_cap, big_launches = drive_path(
        "big_terrain_1024", data, meta, cset, results, "big_frame",
        must=("ray_mask", "ray_mask_hier", "closest_shared", "closest", "any"),
        must_not=("shadow",))
    programs.drop(data)
    del data, cset

    # the single-light shadow call at main-path shapes: 80,000 triangles,
    # each light's plane table within the budget, both together over it
    log("== phase 3b: mid terrain (cells=200, res=512, mirrors) at --ssaa 2, once")
    data, meta, cset = build(terrain_scene, dev, cells=200, res=512,
                             mirror_stripes=True)
    pt, ct = cset.tri_dat.shape[1], cset.tri_dat.shape[1] // 128
    log(f"  scene: {meta.n_tris} triangles, C={ct} clusters, Pt={pt}, "
        f"plane table {pt * 64} bytes per light")
    check(pt * 64 <= ctr.SHADOW_PLANES_BYTES_MAX < 2 * pt * 64,
          "the mid terrain's plane tables do not take one launch per light")
    K.reset_launches()
    with Capture(K) as mcap, eager():
        render_scene(data, meta, cset, 2, dev)
    torch.cuda.synchronize()
    mid_launches = dict(K.launches)
    log(f"  launches in one frame: {mid_launches}")
    for name in ("ray_mask_hier", "shadow"):
        check(mid_launches[name] > 0, f"{name} was not launched on the mid terrain")
    log(f"  single-light shadow launches per frame: {mid_launches['shadow']}")
    check(mid_launches["any"] == 0, "the mid terrain took the any-hit kernel")
    programs.drop(data)
    del data, cset

    # -- phase 4: kernel == plain on the card
    log("== phase 4: kernels vs their plain versions on the card")
    gen = torch.Generator().manual_seed(0)
    max_err = {n: 0.0 for n in KERNELS}

    def checked(label, calls):
        e = check_scene_kernels(label, calls, gen)
        for n in KERNELS:
            max_err[n] = max(max_err[n], e.get(n, 0.0))
        return e

    checked("terrain", cap.calls)
    max_err["ray_mask"] = max(max_err["ray_mask"], check_mask_columns(
        "terrain", cap.calls["ray_mask"], gen))
    e = checked("terrain 64x64", small_cap.calls)
    check(e.get("overflowed", 0) > 0, "no overflowed shortlist was checked")
    checked("big terrain", bcap.calls)
    checked("big terrain 64x64", bsmall_cap.calls)
    checked("mid terrain", mcap.calls)
    # the hierarchical mask on whole calls, at the launch sizes around each
    # per-launch choice, and on the case of tests/torch_hier_case.py (a
    # tile live in every chunk, tiles live in one or none, an inactive tile
    # with its coarse bits set, a partial last chunk); C = 4,096 takes
    # 16-byte stores of the dead chunks, C = 625 and 677 do not
    hier_args = {"big terrain": bcap.calls["ray_mask_hier"],
                 "mid terrain": mcap.calls["ray_mask_hier"], **hier_calls(dev)}
    for label, args in hier_args.items():
        # the case's own bits set the inactive tile's: not the route's
        err = check_hier_whole(label, args, flat=label != "hier case")
        err = max(err, check_hier_launch_sizes(label, args))
        max_err["ray_mask_hier"] = max(max_err["ray_mask_hier"], err)
    for label, n_sph in (("sphere_field(20000)", 20000), ("sphere_field(600)", 600)):
        sd, sm, scs = build(sphere_field, dev, n_spheres=n_sph, res=512)
        log(f"  {label}: {sm.n_spheres} spheres, "
            f"{scs.sph_dat.shape[1] // 128} sphere clusters, {sm.n_lights} light(s)")
        with Capture(K) as scap, eager():
            simg = render_scene(sd, sm, scs, 1, dev)
        check((simg != np.array([15, 20, 40], np.uint8)).any(-1).mean() > 0.1,
              f"{label}: image is background")
        compare_images(
            render_scene(sd, sm, scs, 2, dev, res=64),
            render_scene(*to_cpu(sd, sm, scs), 2, "cpu", res=64),
            f"{label} at 64x64 ssaa 2, cuda vs cpu")
        checked(label, scap.calls)
        if n_sph == 20000:
            one_light = scap.calls["shadow"]
        # the same shadow waves through cluster_any: the sphere walk and
        # its early exit (157 clusters), the dense rows (5)
        budget = ctr.SHADOW_PLANES_BYTES_MAX
        ctr.SHADOW_PLANES_BYTES_MAX = 0
        try:
            with Capture(K) as acap, eager():
                aimg = render_scene(sd, sm, scs, 1, dev)
        finally:
            ctr.SHADOW_PLANES_BYTES_MAX = budget
        compare_images(aimg, simg, f"{label} through cluster_any vs the shadow kernel")
        checked(label + " through cluster_any", {"any": acap.calls["any"]})
        programs.drop(sd)

    # the exact-tie case of the CPU tests (tests/torch_tie_case.py):
    # duplicated and edge-sharing triangles across clusters, sphere-triangle
    # ties, list overflows
    checked("tie case", tie_calls(dev))
    # the NaN-poison case of the CPU tests (tests/torch_poison_case.py): a
    # lane >= 0 in one visit and NaN in another, in the same and in
    # different warp groups, does not occlude
    for label, args in poison_calls(dev).items():
        checked(label, {"shadow": args})

    # -- phase 5: timings at the phase-3 and phase-3b shapes
    log("== phase 5: kernel timings at the shapes of the two frames")
    pairs = kernel_pairs()
    frames = {"full_width": (cap, launches, results.get("frame_profile")),
              "big": (bcap, big_launches, results.get("big_frame_profile"))}
    rows = []
    for name in KERNELS:
        # the row's call: the full-width frame's, the big terrain's for the
        # kernels that only it runs; the hierarchical mask also at the mid
        # terrain's (S = 5 chunks, 8,192 tiles a launch)
        primary = "big" if name in ("ray_mask_hier", "any") else "full_width"
        sources = [(frame, fcap) for frame, (fcap, _, _) in frames.items()]
        if name == "ray_mask_hier":
            sources.append(("mid", mcap))
        calls = []
        for frame, fcap in sources:
            args = frame_call(fcap, name)
            if args is None:
                continue
            ms = time_call(pairs[name][0], args, 10)
            ops, byt = work(name, args)
            t_ops, t_bytes = ops / PEAK_FP32 * 1e3, byt / PEAK_BYTES * 1e3
            call = {"frame": frame, "ms": ms, "bound_ms": max(t_ops, t_bytes),
                    "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                    "visits": call_spread(name, args)}
            if frame in (primary, "mid"):
                call["plain_ms"] = time_once(pairs[name][1], args)
            calls.append(call)
            what = ("live chunks per active tile" if name == "ray_mask_hier"
                    else "visits per tile")
            log(f"  {name} ({frame} frame's busiest call): {ms:.4f} ms/launch, "
                f"bound {call['bound_ms']:.4f} ms ({call['bound_by']}: "
                f"{ops:.3e} ops, {byt:.3e} bytes), {call['bound_ms'] / ms:.3f} "
                f"of the bound" + (f", plain {call['plain_ms']:.2f} ms"
                                   if "plain_ms" in call else "")
                + (f"; {what} {call['visits']}" if call["visits"] else ""))
        main = next(c for c in calls if c["frame"] == primary)
        per_frame = {}
        for frame, (_, fl, prof) in frames.items():
            dev_ms = prof["by_kernel"].get(name, [0.0, 0])[0] if prof else None
            per_frame[frame] = {"device_ms": dev_ms, "launches": fl[name]}
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": frames[primary][1][name],
            "max_abs_err": max_err[name], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "frames": per_frame, "calls": calls,
        })
    # each frame's ranking: the device time a kernel loses against its
    # bound, device ms x (1 - bound / ms) with that frame's busiest call
    for frame in frames:
        loss = []
        for row in rows:
            call = next((c for c in row["calls"] if c["frame"] == frame), None)
            dev_ms = row["frames"][frame]["device_ms"]
            if call is not None and dev_ms:
                loss.append((dev_ms * (1 - call["bound_ms"] / call["ms"]),
                             row["name"], dev_ms, row["frames"][frame]["launches"]))
        loss.sort(reverse=True)
        log(f"  {frame} frame, kernels by device ms lost against the bound: "
            + ", ".join(f"{n} {l:.3f} of {d:.3f} ms ({c} launches)"
                        for l, n, d, c in loss))
    # the single-light call shape (TPU row 5) is not on the 2-light main
    # path: timed on the mid terrain's and the sphere field's shadow waves
    for label, args in (("mid terrain at 1024x1024 rays", mcap.calls["shadow"]),
                        ("sphere_field(20000) at 512x512, walk + early exit",
                         one_light)):
        ms = time_call(K.shadow, args, 10)
        ops, byt = work("shadow", args)
        bound_ms = max(ops / PEAK_FP32, byt / PEAK_BYTES) * 1e3
        plain_ms = time_once(K.shadow_plain, args)
        log(f"  shadow, 1 light ({label}): {ms:.4f} ms/launch, "
            f"bound {bound_ms:.4f} ms ({ops:.3e} ops, {byt:.3e} bytes), "
            f"plain {plain_ms:.2f} ms")
        results.setdefault("shadow_1_light", []).append(
            {"where": label, "ms": ms, "bound_ms": bound_ms, "plain_ms": plain_ms})
    log("== phase 5b: the forward bounce epilogue at the horse frame's shapes")
    rows += epilogue_on_card(dev, results)
    log("== phase 5c: the shortlist compaction at the horse and big frames' "
        "busiest calls")
    rows.append(compact_on_card(dev, results))
    log("== phase 5d: the shared-eye interval tile mask at the big band's and "
        "the horse frame's calls")
    rows.append(tile_mask_on_card(dev, results))
    log("  library_ms: null for every kernel; no single PyTorch call computes "
        "a slab mask over cluster shortlists (flat or gated by superclusters), "
        "a shortlist closest hit, a plane-table shadow test or a shortlist "
        "segment any-hit")
    # -- phase 6: the render modes beyond one whole frame
    log("== phase 6: streamed bands, jitter and adaptive on the full-width "
        "terrain; the big terrain streamed in jitter mode")
    path_launches = render_modes(dev, results, dict(cells=126, res=1024),
                                 dict(cells=512, res=1024), 512, checked)
    log("== phase 6b: the threefry draw kernel against its plain version and "
        "JAX's draws")
    threefry = threefry_on_card(dev, results)
    log("== phase 6c: the full-width terrain on treelet clusters")
    path_launches["treelet_frame"] = treelet_frame(dev, results, checked)
    # -- phase 7: training at full width
    log("== phase 7: make_train_step on the full-width terrain, 1,048,576 rays "
        "a step")
    path_launches["train_step"] = train_full_width(dev, results, checked)
    log("== phase 7b: one training step on CUDA against the CPU")
    train_cuda_vs_cpu(dev, results)
    log("== phase 7c: examples/inverse_rendering_torch.py on the entry scene")
    example_on_card(results)
    # -- phase 8: the mesh, two processes, sharded training, the server
    log("== phase 8a: the full-width terrain on a 2-shard mesh of cuda:0")
    path_launches["mesh_frame"] = mesh_on_card(dev, results, checked)
    log("== phase 8b: two processes on the card (gloo), the full-width frame "
        "and 3 sharded steps")
    path_launches["rank2_frame"], path_launches["rank2_step"] = two_ranks(
        results)
    log("== phase 8c: phase 7's training on a 2-shard mesh of cuda:0")
    path_launches["mesh_train_step"] = train_on_mesh(dev, results, checked)
    log("== phase 8d: the render server (stdin, TCP, in process)")
    path_launches["served_frame"] = serve_on_card(dev, results, checked)
    log("== phase 8e: measure_scaling over 1 and 2 logical shards of one card")
    scaling_on_card(dev, results)
    log("== phase 9: the compiled programs, eager against replayed")
    programs_on_card(dev, results)
    log("== phase 10: brute and BVH programs, eager against replayed")
    engine_programs(dev, results)
    # the draw kernel's row: its launches in the jitter frame of phase 6,
    # one band; JAX_DRAWS's checks were exact (max_abs_err 0); per frame,
    # the draws' device ms timed with events in phase 6's eager frames (the
    # same draws as inside the replayed graphs); the bound is the issue
    # ceiling (phase 6b)
    rows.append({
        "name": "threefry", "route": "cuda", "source": SOURCES["threefry"],
        "replaces": REPLACES["threefry"],
        "launches": path_launches["jitter_ssaa2"]["threefry"], "max_abs_err": 0.0,
        "ms": threefry["ms"], "plain_ms": threefry["plain_ms"],
        "bound_ms": threefry["bound_ms"], "bound_by": threefry["bound_by"],
        "library_ms": None,
        "frames": {f: {"device_ms": results[f]["draw_ms"],
                       "launches": path_launches[f]["threefry"]}
                   for f in ("jitter_ssaa2", "adaptive")},
    })
    for row in rows:
        row["path_launches"] = {k: v.get(row["name"], 0)
                                for k, v in path_launches.items()}
        row["max_abs_err"] = max_err.get(row["name"], row["max_abs_err"])
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
    if sys.argv[1:2] == ["--worker"]:
        return rank_worker(int(sys.argv[2]), sys.argv[3])
    try:
        return run()
    except Failure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
