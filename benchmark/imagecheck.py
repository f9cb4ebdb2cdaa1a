"""The comparison of rendered images with the plain reference: square
tiles of output pixels drawn from the seed, rendered by the reference
(``reference.whitted.tiles_image``), held against the program's pixels.

Two numbers, each with its limit in ``benchmark/limits/<workload>.json``:

- ``px_off_share``: the share of sampled pixels with some channel more
  than 1 apart (rounding moves a channel by 1; a wrong hit, normal,
  shadow or bounce moves it further);
- ``mean_abs_lsb``: the mean absolute difference per sampled channel.
"""

from __future__ import annotations

import numpy as np

TILE = 16


def sample_tiles(rng, height: int, width: int, n: int) -> np.ndarray:
    """(n, 2) top-left corners of distinct TILE x TILE tiles of the
    height x width image, drawn from ``rng``."""
    grid = (height // TILE) * (width // TILE)
    pick = rng.choice(grid, size=min(n, grid), replace=False)
    return np.stack([pick // (width // TILE) * TILE,
                     pick % (width // TILE) * TILE], 1)


class Tally:
    """Sums of the two numbers over every compared tile."""

    def __init__(self):
        self.pixels = self.off = 0
        self.abs_sum = 0.0
        self.images = 0

    def add(self, ref_tiles: np.ndarray, image: np.ndarray, tiles) -> None:
        """``ref_tiles`` (n, TILE, TILE, 3) against the same tiles of the
        program's ``image`` (H, W, 3) uint8."""
        for (r, c), ref in zip(tiles, ref_tiles):
            got = image[r:r + TILE, c:c + TILE].astype(np.int32)
            d = np.abs(got - ref.astype(np.int32))
            self.pixels += d.shape[0] * d.shape[1]
            self.off += int((d.max(-1) > 1).sum())
            self.abs_sum += float(d.sum())
        self.images += 1

    def report(self, ctx) -> None:
        """Both numbers into ``ctx``'s checks; with nothing compared, both
        read as far off as they can (no image is no answer)."""
        if not self.pixels:
            ctx.check("px_off_share", 1.0)
            ctx.check("mean_abs_lsb", 255.0)
            return
        ctx.check("px_off_share", self.off / self.pixels)
        ctx.check("mean_abs_lsb", self.abs_sum / (3 * self.pixels))

