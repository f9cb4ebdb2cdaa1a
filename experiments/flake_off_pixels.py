"""Where the sphereflake cell's off pixels lie, on the card:

    python3 experiments/flake_off_pixels.py --seeds 1,2,3 [--frames 4] \
        [--tiles 24]

For each seed the port renders ``--frames`` frames of
``flake66k.frame-ssaa2`` (the frame driver's camera sweep, frames drawn
from the seed as the calibration draws them) through
``render_one_camera``, and the plain reference renders ``--tiles`` tiles
of each, drawn as the benchmark's check draws them.  A pixel is off where
a channel is more than 1 apart.  For every compared pixel the reference's
eye rays of its SSAA samples are traced to their first hit, and the
pixel is put in the finest class that one of its samples reaches:
``fine`` (a sphere of the two finest levels, 4 and 5: radius 0.5 / 81
and below), ``sphere`` (a coarser sphere), ``ground`` or ``background``.
Prints one JSON line a seed: the pixels and the off pixels of each class,
and the share of off pixels on the finest spheres, which tells the
float32 rounding of the sphere quadratic on silhouettes a couple of
samples wide from a fault elsewhere.

``--against float64`` puts the plain reference computed in float64 in
the port's place (no port render): how far float32 rounding alone moves
this scene's pixels.  ``--max-depth`` renders both sides with another
recursion depth (0: no mirror bounce), ``--size-factor`` and ``--width``
another flake and view (a rehearsal on the CPU, or the size factor below
the cell's)."""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import imagecheck, sceneio  # noqa: E402
from benchmark.calibrate import NOMINAL_FRAMES  # noqa: E402
from benchmark.drivers.frame import camera_at, port_camera  # noqa: E402
from benchmark.paths import Bench  # noqa: E402
from benchmark.reference import whitted as ref  # noqa: E402

WORKLOAD = "flake66k.frame-ssaa2"
CLASSES = ("fine", "sphere", "ground", "background")


def classify(scene, cam, ssaa: int, tiles, root_radius: float) -> np.ndarray:
    """(n, TILE, TILE) class index of every pixel of ``tiles``: the finest
    class one of its SSAA samples' first hits reaches."""
    t, dev = imagecheck.TILE, scene.device
    side = t * ssaa
    yy, xx = torch.meshgrid(torch.arange(side, device=dev),
                            torch.arange(side, device=dev), indexing="ij")
    tl = torch.as_tensor(np.asarray(tiles), device=dev).reshape(-1, 2)
    rows = (tl[:, 0, None] * ssaa + yy.flatten()[None]).flatten()
    cols = (tl[:, 1, None] * ssaa + xx.flatten()[None]).flatten()
    o, d = ref.eye_rays(cam, cam["width"] * ssaa, cam["height"] * ssaa, rows,
                        cols, dev)
    prim = ref._grouped(scene.closest, 1024, o.expand(d.shape), d)
    sph = prim - scene.n_tris
    rad = scene.sph_r[sph.clamp(min=0)]
    level = torch.round(torch.log(root_radius / rad) / np.log(3.0))
    cls = torch.where(prim < 0, 3, torch.where(sph < 0, 2,
                                               torch.where(level >= 4, 0, 1)))
    cls = cls.view(-1, t, ssaa, t, ssaa).amin((2, 4))
    return cls.cpu().numpy()


def main(argv=None) -> int:
    from raytracer_tpu_torch.models.scene import load_scene
    from raytracer_tpu_torch.pipeline import render_one_camera
    from raytracer_tpu_torch.render import engine_accel

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="1,2,3")
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--tiles", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    # a rehearsal on the CPU: a smaller flake at a smaller view
    ap.add_argument("--size-factor", type=int)
    ap.add_argument("--width", type=int)
    ap.add_argument("--max-depth", type=int)
    ap.add_argument("--against", choices=("port", "float64"), default="port")
    ap.add_argument("--work-dir", default=os.environ.get("TMPDIR", "/tmp"))
    args = ap.parse_args(argv)
    bench = Bench(ROOT)
    cfg = bench.config(bench.workload(WORKLOAD)["config"])
    tr = bench.traffic(bench.workload(WORKLOAD)["traffic"])
    if args.size_factor is not None:
        cfg["scene"]["size_factor"] = args.size_factor
    if args.width is not None:
        cfg["scene"].update(width=args.width, height=args.width)
    if args.max_depth is not None:
        cfg["scene"]["max_depth"] = args.max_depth
    dev, ssaa = args.device, tr["ssaa"]
    for seed in (int(s) for s in args.seeds.split(",")):
        parsed = sceneio.generate(bench, cfg, seed)
        xml = os.path.join(args.work_dir, "flake_off_pixels.xml")
        sceneio.write_xml(parsed, xml)
        data, meta = load_scene(xml, device=dev)
        accel = engine_accel(tr["engine"], None, data, meta, dev)
        cam0 = parsed["cameras"][tr["camera"]]
        rng = np.random.default_rng(abs(seed))
        picks = sorted(int(k) for k in rng.choice(NOMINAL_FRAMES,
                                                  size=args.frames,
                                                  replace=False))
        images = [None] * len(picks)
        if args.against == "port":
            images = [render_one_camera(
                data, meta, port_camera(camera_at(cam0, k, tr)), accel,
                ssaa=ssaa, ssaa_mode=tr["ssaa_mode"], chunk=tr["chunk"],
                engine=tr["engine"], device=dev)[0] for k in picks]
        del data, meta, accel
        scene = ref.Scene(parsed, dev)
        wide = (ref.Scene(parsed, dev, torch.float64)
                if args.against == "float64" else None)
        pixels = np.zeros(len(CLASSES), np.int64)
        off = np.zeros(len(CLASSES), np.int64)
        for k, image in zip(picks, images):
            cam = camera_at(cam0, k, tr)
            tiles = imagecheck.sample_tiles(rng, cam["height"], cam["width"],
                                            args.tiles)
            want = ref.tiles_image(scene, cam, ssaa, tiles,
                                   imagecheck.TILE).cpu().numpy()
            cls = classify(scene, cam, ssaa, tiles,
                           cfg["scene"]["root_radius"])
            if wide is not None:
                image = np.zeros((cam["height"], cam["width"], 3), np.uint8)
                for (r, c), t in zip(tiles, ref.tiles_image(
                        wide, cam, ssaa, tiles, imagecheck.TILE).cpu().numpy()):
                    image[r:r + imagecheck.TILE, c:c + imagecheck.TILE] = t
            for (r, c), w, cl in zip(tiles, want, cls):
                got = image[r:r + imagecheck.TILE, c:c + imagecheck.TILE]
                bad = (np.abs(got.astype(np.int32) - w.astype(np.int32))
                       .max(-1) > 1)
                pixels += np.bincount(cl.ravel(), minlength=len(CLASSES))
                off += np.bincount(cl[bad], minlength=len(CLASSES))
        print(json.dumps({
            "seed": seed, "against": args.against,
            "size_factor": cfg["scene"]["size_factor"],
            "max_depth": cfg["scene"]["max_depth"], "frames": picks,
            "pixels": dict(zip(CLASSES, pixels.tolist())),
            "off": dict(zip(CLASSES, off.tolist())),
            "off_share": float(off.sum() / pixels.sum()),
            "fine_share_of_off": (float(off[0] / off.sum()) if off.sum()
                                  else None)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
