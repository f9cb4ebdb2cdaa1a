"""Operations and bytes of the port's CUDA kernels, and the roofline
bound of a frame's calls.

A frozen copy of ``chip_smoke.py``'s counts (``OPS``, ``nbytes``,
``any_needed``, ``shadow_needed``, ``work``, ``named``): the operations
and bytes that each kernel call's data needs, the any-hit and shadow
kernels' replayed with the plain versions' visit tables up to each ray's
first hit.  They are held against the card's FP32 issue rate, one
operation per lane and cycle (the kernels are built with ``-fmad=false``,
so every multiply and add issues on its own): SMs x 128 x the maximum SM
clock, and against 3.35 TB/s of HBM3 (NVIDIA's H100 SXM data sheet).
"""

from __future__ import annotations

import functools
import inspect
import subprocess

import torch

PEAK_BYTES = 3.35e12
FP32_LANES_PER_SM = 128

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


def named(kname, a):
    """The captured positional call ``a`` of kernel ``kname`` as a dict
    keyed by the wrapper's parameter names."""
    fn = kernel_pairs()[kname][0]
    bound = inspect.signature(fn).bind(*a)
    bound.apply_defaults()
    return dict(bound.arguments)


def kernel_pairs():
    """{kernel: (wrapper, plain version)}."""
    from raytracer_tpu_torch.ops import kernels as K

    return {"ray_mask": (K.ray_mask, K.ray_mask_plain),
            "ray_mask_hier": (K.ray_mask_hier, K.ray_mask_hier_plain),
            "closest": (K.closest, K.closest_plain),
            "closest_shared": (K.closest, K.closest_plain),
            "shadow": (K.shadow, K.shadow_plain),
            "any": (K.any_hit, K.any_hit_plain)}


def nbytes(*xs):
    return sum(x.numel() * x.element_size() for x in xs
               if isinstance(x, torch.Tensor))


def _stop_pairs(hit, live):
    """(n, 128) pairs each ray tests in one visit when it stops at its first
    hit: the lanes up to the first hit lane, all 128 on a miss; 0 for rays
    not ``live``.  hit: (n, 128 rays, 128 lanes) bool."""
    first = hit.to(torch.uint8).argmax(-1)      # the first hit lane
    return torch.where(hit.any(-1), first + 1, 128) * live


def any_needed(p):
    """[triangle pairs, sphere pairs, triangle visits, sphere visits] that
    the any_hit call ``p`` (by name) needs: every ray stops at its first
    hit and a tile once all its rays are found, as the kernel's loops do.
    Replayed with the plain version's visit tables and tests."""
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


def peak_ops() -> float:
    """The FP32 issue rate of card 0: SMs x 128 lanes x its maximum SM
    clock, as ``nvidia-smi`` reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits",
         "-i", "0"], capture_output=True, text=True, check=True).stdout
    mhz = float(out.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * FP32_LANES_PER_SM * mhz * 1e6


class Recorder:
    """``with Recorder(peak_ops) as r:`` around an eager frame wraps the
    kernel wrappers of ``ops.kernels``; every call adds its bound, the
    larger of its operations over ``peak_ops`` and its bytes over
    ``PEAK_BYTES``, to ``r.bound_s`` (and its count to ``r.calls``)."""

    NAMES = ("ray_mask", "ray_mask_hier", "closest", "shadow", "any_hit")

    def __init__(self, peak: float):
        from raytracer_tpu_torch.ops import kernels

        self.k, self.peak = kernels, peak
        self.orig = {n: getattr(kernels, n) for n in self.NAMES}
        self.bound_s, self.calls, self.ops, self.bytes = 0.0, 0, 0, 0

    def _wrap(self, name):
        orig = self.orig[name]
        sig = inspect.signature(orig)

        @functools.wraps(orig)
        def call(*a, **kw):
            bound = sig.bind(*a, **kw)
            bound.apply_defaults()
            args = tuple(bound.arguments.values())
            kname = name
            if name == "any_hit":
                kname = "any"
            elif name == "closest" and args[6].dim() == 1:
                kname = "closest_shared"
            ops, byt = work(kname, args)
            self.ops += ops
            self.bytes += byt
            self.bound_s += max(ops / self.peak, byt / PEAK_BYTES)
            self.calls += 1
            return orig(*a, **kw)
        return call

    def __enter__(self):
        for n in self.NAMES:
            setattr(self.k, n, self._wrap(n))
        return self

    def __exit__(self, *exc):
        for n, f in self.orig.items():
            setattr(self.k, n, f)
