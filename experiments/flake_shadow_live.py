#!/usr/bin/env python3
"""Count the (ray, sphere cluster) tests of the shadow kernel's sphere
walks in cropped frames of a benchmark cell, on the CPU, with the plain
versions of the kernels.

    python3 experiments/flake_shadow_live.py [--cell flake66k.frame-ssaa2]
        [--crop 64] [--at 0.5,0.5] [--seed 0] [--frame 0]

A crop is a window of crop x crop pixels of the cell's frame at the
frame's own pixel pitch (the camera's near plane cut to the window), its
centre at the fractions ``--at`` of the frame's width and height, rendered
as the cell renders (SSAA 2 parity, the configuration's depth and lights)
from the configuration generated for ``--seed``.  Each shadow call of the
render is replayed, (tile, light) sphere walk by walk and visit by visit,
in the kernel's visit order (the light's sphere list, the ascending bitmask
past its cap, every cluster with at most 8), counting the ray slots each
rule tests:

- ``today``: all 128 rays of a visit, until all 128 are occluded (the walk
  before the live-ray walk: 4 rays a thread, a tile stops once every ray is
  found);
- ``group_skip``: the 32-ray groups holding a ray not yet occluded;
- ``found_skip``: the rays not yet occluded, active or not;
- ``live_groups``: the 32-ray groups holding a ray active toward the light
  and not yet occluded (a live ray);
- ``live``: the live rays (the live-ray walk);
- ``live_32``: ``live`` rounded up to a whole number of 32-ray groups (the
  live rays packed into groups);

and the tile visits made before a tile's rays are all occluded, in the
kernel's order and with the overflowing tiles' bitmask walked front to back
by slab entry.  Prints one JSON line: the counts and each rule's share of
``today``.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import sceneio  # noqa: E402
from benchmark.drivers.frame import camera_at, port_camera  # noqa: E402
from benchmark.paths import Bench  # noqa: E402

RULES = ("today", "group_skip", "found_skip", "live_groups", "live",
         "live_32")


def crop_camera(cam: dict, crop: int, at) -> dict:
    """``cam`` cut to a crop x crop window centred at fractions ``at`` of
    its width and height (row 0 at the top), at its own pixel pitch."""
    l, r, b, t = cam["near_plane"]
    w, h = cam["width"], cam["height"]
    x0 = min(max(int(round(at[0] * w)) - crop // 2, 0), w - crop)
    y0 = min(max(int(round(at[1] * h)) - crop // 2, 0), h - crop)
    px, py = (r - l) / w, (t - b) / h
    plane = [l + px * x0, l + px * (x0 + crop), t - py * (y0 + crop), t - py * y0]
    return dict(cam, near_plane=plane, width=crop, height=crop)


def _groups(mask):
    """(n, 128) bool -> 32 x the 32-ray groups holding a set bit."""
    return 32 * mask.view(mask.shape[0], 4, 32).any(-1).sum()


def count_call(args, cset, counts):
    """Add one shadow call's counts (``args``: its positional arguments)."""
    from raytracer_tpu_torch.ops import cluster_trace as ctr
    from raytracer_tpu_torch.ops import kernels as K

    tw, tl, tc, sw, sl, sc, lps, origin, planes, sph, relaxed = args[:11]
    act = args[11] if len(args) > 11 and args[11] is not None else None
    nl, r = planes.shape[0], origin.shape[0]
    nt, cs = r // K.TILE, sph.shape[1] // K.CLUSTER
    flat = sph.clone()
    flat[3] = 0.0
    tri = K.shadow_plain(tw, tl, tc, sw, sl, sc, lps, origin, planes, flat,
                         relaxed)
    o = origin.view(nt, K.TILE, 3)
    ox, oy, oz = o[:, :, None, 0], o[:, :, None, 1], o[:, :, None, 2]
    ones = torch.ones((r,))
    gate = (sc != 0).any(0)
    for l in range(nl):
        seg = (lps[3 * l] - ox, lps[3 * l + 1] - oy, lps[3 * l + 2] - oz)
        want = (torch.ones((nt, K.TILE), dtype=torch.bool) if act is None
                else (act[l] != 0).view(nt, K.TILE))
        tri_l = ((tri >> l) & 1).view(nt, K.TILE) != 0
        if cs <= K.DENSE_SPH_ROWS:
            walks = gate
            orders = {"kernel": torch.where(gate[:, None], torch.arange(cs)[None], -1)}
        else:
            walks = sc[l] != 0
            vis = K._visit_table(sw[l], sl[l], sc[l], cs, K.MAX_SPH_LIST, 0, nt)
            _, (sh, se) = ctr._cluster_masks(cset, origin, lps[3 * l:3 * l + 3][None]
                                             - origin, want.reshape(-1), ones)
            key = torch.where(sh, se, float("inf"))
            ftb = torch.sort(key, dim=1, stable=True).indices
            ftb = torch.where(torch.arange(cs)[None] < sc[l][:, None].clamp(max=cs),
                              ftb, -1)
            over = (sc[l] > K.MAX_SPH_LIST)[:, None]
            width = max(vis.shape[1], ftb.shape[1])
            pad = lambda x: torch.nn.functional.pad(  # noqa: E731
                x, (0, width - x.shape[1]), value=-1)
            orders = {"kernel": vis,
                      "front_to_back": torch.where(over, pad(ftb), pad(vis))}
        counts["slots"] += K.TILE * int(walks.sum())
        counts["live_at_start"] += int(((want & ~tri_l).sum(1) * walks).sum())
        for name, vis in orders.items():
            occ = tri_l.clone()
            for v in range(vis.shape[1]):
                k = vis[:, v]
                valid = ((k >= 0) & walks)[:, None]
                if not bool(valid.any()):
                    continue
                going = valid[:, 0] & ~occ.all(1)
                counts[f"tile_visits_{name}"] += int(going.sum())
                if name == "kernel":
                    g = going[:, None]
                    counts["today"] += K.TILE * int(going.sum())
                    counts["group_skip"] += int(_groups(~occ & g))
                    counts["found_skip"] += int((~occ & g).sum())
                    live = (want & ~occ & g).sum(1)
                    counts["live_groups"] += int(_groups(want & ~occ & g))
                    counts["live"] += int(live.sum())
                    counts["live_32"] += 32 * int(((live + 31) // 32).sum())
                hit = K._sph_occluded(K._gather(sph, k), ox, oy, oz, *seg,
                                      relaxed).any(-1)
                occ |= hit & valid


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", default="flake66k.frame-ssaa2")
    ap.add_argument("--crop", type=int, default=64)
    ap.add_argument("--at", default="0.5,0.5")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frame", type=int, default=0)
    a = ap.parse_args()

    from raytracer_tpu_torch.models.scene import from_parsed
    from raytracer_tpu_torch.ops import kernels as K
    from raytracer_tpu_torch.pipeline import render_one_camera
    from raytracer_tpu_torch.render import engine_accel

    bench = Bench(ROOT)
    cell = next(w for w in bench.spec["workloads"] if w["name"] == a.cell)
    cfg = copy.deepcopy(bench.config(cell["config"]))
    tr = bench.traffic(cell["traffic"])
    parsed = sceneio.generate(bench, cfg, a.seed)
    data, meta = from_parsed(parsed, "cpu")
    accel = engine_accel(tr["engine"], None, data, meta, "cpu")
    cam = camera_at(parsed["cameras"][tr["camera"]], a.frame, tr)
    cam = crop_camera(cam, a.crop, [float(x) for x in a.at.split(",")])

    counts = dict.fromkeys(RULES + ("slots", "live_at_start", "calls",
                                    "tile_visits_kernel",
                                    "tile_visits_front_to_back"), 0)
    shadow = K.shadow

    def counted(*args):
        counts["calls"] += 1
        count_call(args, accel, counts)
        return shadow(*args)

    K.shadow = counted
    try:
        render_one_camera(data, meta, port_camera(cam), accel, ssaa=tr["ssaa"],
                          ssaa_mode=tr["ssaa_mode"], chunk=tr["chunk"],
                          engine=tr["engine"], device="cpu")
    finally:
        K.shadow = shadow
    out = {"cell": a.cell, "seed": a.seed, "frame": a.frame, "crop": a.crop,
           "at": a.at, **counts}
    out["share"] = {k: counts[k] / max(counts["today"], 1) for k in RULES}
    out["live_share_at_start"] = counts["live_at_start"] / max(counts["slots"], 1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
