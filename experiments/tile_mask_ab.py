"""A/B of the interval tile mask kernel against other versions on the card.

    python3 experiments/tile_mask_ab.py --extra OLD=_archive/tile_mask.cu \
        [--extra NAME=PATH ...] [--reps 3]

Each version, the tree's ``csrc/tile_mask.cu`` ("tree") and each
``--extra`` source (a path in the repo, e.g. a parent's copy or a patched
one), is built into a library of its own under ``_build/ab_tm/``.  At the
terrain524k band's shape (1,024 tiles x 4,096 columns), the horse31k
frame's (32,400 x 247) and the marbles650 frame's (32,768 x 6) every
version equals the plain version on the card (hit everywhere, entry where
not NaN; a name starting with "probe" is a deliberately broken copy that
is timed only), then ms a launch (10 launches behind a spin), the
versions in turn, ``--reps`` rounds.  Prints one JSON line a version.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SHAPES = {"terrain": (1024, 4096, True, False),
          "horse": (32400, 247, True, True),
          "marbles": (32768, 6, True, True)}


def build(name, source=None):
    from raytracer_tpu_torch import backend

    src = backend.CSRC_DIR
    out_dir = os.path.join(backend.BUILD_DIR, "ab_tm", name)
    csrc = os.path.join(out_dir, "csrc")
    os.makedirs(csrc, exist_ok=True)
    for f in ("common.cuh", "ray_mask.cu"):
        shutil.copy(os.path.join(src, f), csrc)
    shutil.copy(source or os.path.join(src, "tile_mask.cu"),
                os.path.join(csrc, "tile_mask.cu"))
    lib = os.path.join(out_dir, "lib.so")
    backend.compile_library(csrc, lib, os.path.join(out_dir, "build.log"))
    with open(os.path.join(out_dir, "build.log")) as f:
        part = f.read().split("== tile_mask.cu")[-1]
    regs = [line.strip() for line in part.splitlines() if "registers" in line]
    return lib, regs


def inputs(nt, c, shared, partial, dev):
    import numpy as np
    import torch

    rng = np.random.default_rng(nt + c)
    r = nt * 128
    axis = rng.normal(size=(nt, 1, 3)) * [0.4, 0.3, 0.2] + [0.0, -0.4, -1.0]
    d = (axis + rng.normal(size=(nt, 128, 3)) * 0.01).astype(np.float32)
    d = d.reshape(r, 3)
    o = np.broadcast_to(np.float32([0.5, 30.0, 60.0]), (r, 3)).copy()
    if not shared:
        o += rng.normal(size=(r, 3)).astype(np.float32)
    act = rng.random(r) < (0.9 if partial else 1.0)
    cmin = rng.uniform(-60.0, 60.0, (c, 3)).astype(np.float32)
    cmin[:, 1] = rng.uniform(-5.0, 25.0, c)
    cmax = (cmin + rng.uniform(0.5, 12.0, (c, 3))).astype(np.float32)
    t = [torch.from_numpy(x).to(dev) for x in (o, d, act, cmin, cmax)]
    return (*t, None, 128, 1)


def main():
    import torch

    import chip_smoke
    from raytracer_tpu_torch import backend
    from raytracer_tpu_torch.ops import kernels as K

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--extra", action="append", default=[],
                    help="NAME=PATH: a version built from another source")
    a = ap.parse_args()
    sources = {"tree": None}
    for spec in a.extra:
        n, path = spec.split("=", 1)
        sources[n] = os.path.join(REPO, path)
    names = list(sources)
    dev = torch.device("cuda")
    libs = {}
    for n in names:
        libs[n] = build(n, sources[n])
    args = {k: inputs(*v, dev) for k, v in SHAPES.items()}
    want = {k: K.tile_mask_plain(*x) for k, x in args.items()}
    ms = {n: {k: [] for k in SHAPES} for n in names}
    for n in names:
        backend.load_library(libs[n][0])
        for k, x in args.items():
            h, e = K.tile_mask(*x)
            ph, pe = want[k]
            ok = (torch.equal(h, ph)
                  and torch.equal(torch.isnan(e), torch.isnan(pe))
                  and bool(((e == pe) | torch.isnan(pe)).all()))
            if not ok and not n.startswith("probe"):
                raise SystemExit(f"version {n} differs from the plain version at {k}")
    for _ in range(a.reps):
        for n in names:
            backend.load_library(libs[n][0])
            for k, x in args.items():
                ms[n][k].append(chip_smoke.time_call(K.tile_mask, x, 10))
    for n in names:
        print(json.dumps({"version": n, "source": sources[n],
                          "regs": libs[n][1][-1:] if libs[n][1] else None,
                          "ms": {k: sorted(v)[len(v) // 2] for k, v in ms[n].items()},
                          "all_ms": ms[n]}), flush=True)


if __name__ == "__main__":
    main()
