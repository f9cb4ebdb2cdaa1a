"""Image comparison CLI: ``python -m raytracer_tpu_torch.compare a b``.

A copy of ``raytracer_tpu/compare.py`` (the same statistics, JSON line
and exit status) reading PPM, PNG and EXR with the port's own readers.
It prints the differing-channel fraction, max |delta|, MSE and the count
of big differences between two rendered images.

Exit status: 0 if the images match within the given tolerances (the
defaults follow the reference binary's own noise against the course's
golden images), 1 otherwise.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _read(path: str) -> np.ndarray:
    if path.endswith(".png"):
        from raytracer_tpu_torch.utils.png import read_png

        return read_png(path)
    if path.endswith(".exr"):
        # HDR radiance: quantize with the renderer's tone semantics so
        # the stats stay in the same uint8 domain as PPM/PNG inputs
        from raytracer_tpu_torch.utils.exr import read_exr

        radiance = np.clip(read_exr(path), 0.0, 255.0)
        return np.floor(radiance + 0.5).astype(np.uint8)
    from raytracer_tpu_torch.utils.ppm import read_ppm

    return read_ppm(path)


def diff_stats(a: np.ndarray, b: np.ndarray, big: int = 8) -> dict:
    """Channel-difference statistics between two (H, W, 3) uint8 images."""
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    return {
        "shape": list(a.shape[:2]),
        "channels": int(d.size),
        "differing": int((d > 0).sum()),
        "frac_diff": float((d > 0).mean()),
        "max_abs": int(d.max()),
        "mse": float((d.astype(float) ** 2).mean()),
        f"channels_gt_{big}": int((d > big).sum()),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="diff two rendered images (PPM or PNG)")
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--frac-tol", type=float, default=0.02,
                    help="max fraction of differing channels (default "
                         "matches the reference binary's noise vs the TA "
                         "goldens)")
    ap.add_argument("--mse-tol", type=float, default=6.0,
                    help="max mean squared channel error")
    ap.add_argument("--big", type=int, default=8,
                    help="|delta| above this counts as a big difference")
    ap.add_argument("--big-frac-tol", type=float, default=1e-3,
                    help="max fraction of big differences")
    args = ap.parse_args(argv)

    a, b = _read(args.a), _read(args.b)
    if a.shape != b.shape:
        print(json.dumps({"error": "shape mismatch",
                          "a": list(a.shape), "b": list(b.shape)}))
        return 1
    stats = diff_stats(a, b, big=args.big)
    ok = (
        stats["frac_diff"] <= args.frac_tol
        and stats["mse"] <= args.mse_tol
        and stats[f"channels_gt_{args.big}"] / stats["channels"]
        <= args.big_frac_tol
    )
    stats["match"] = bool(ok)
    print(json.dumps(stats))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
