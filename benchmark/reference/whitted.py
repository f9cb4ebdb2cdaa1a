"""The plain reference: a Whitted ray tracer of the CENG477 semantics in
plain PyTorch, written from the reference binary's description
(``SURVEY.md`` sections 2-3) and independent of the program under test.

Semantics: eye rays through pixel centres, unnormalized (``s - e``);
triangles by Cramer's rule with inclusive edges and t >= 0, no culling;
spheres by the quadratic's smaller root, kept even when negative unless
both roots are; the closest hit is the smallest t, the lowest primitive
index on an exact tie (triangles in file order, then spheres); ambient
at every bounce; shadow rays from the point offset along the geometric
normal by the scene's epsilon, occluded by any hit with t < 1 on the
unnormalized segment to the light; irradiance over the distance from the
offset point, the cosine from the unoffset point; Blinn-Phong specular
gated by acos(cos) * 180 / 3.1415 <= 90.01; the background on a miss at
depth 0 only; mirror materials reflect from the offset point, tinted by
the mirror reflectance, down to ``max_depth``.  Colours are quantized by
rounding half up after a clamp to [0, 255]; SSAA parity averages the
quantized samples with truncating integer division.

The only acceleration is culling, which changes no answer: triangles
are sorted along a Morton curve of their centroids and cut into blocks
of ``BLOCK``; a group of coherent rays (``group``: consecutive rays that
the caller ordered by screen tiles) tests only the triangles of blocks
whose padded box one of its rays enters.  The triangle test is Cramer's
rule with its determinants written as scalar triple products, so that
one matrix product over (ray, triangle) pairs gives them all.

``dtype``: the precision of every intersection and shading operation
(float32; bfloat16 for the control that must fail the comparison).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

SPEC_GATE_DEG = 90.01
RAD_TO_DEG = 180.0 / 3.1415
BLOCK = 64
PAIRS = 1 << 23          # (ray, triangle) pairs in one pass


def _cross(u, v):
    return torch.stack([u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1],
                        u[..., 2] * v[..., 0] - u[..., 0] * v[..., 2],
                        u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]], -1)


def _dot(u, v):
    return (u * v).sum(-1)


def _normalize(v):
    return v / torch.sqrt((v * v).sum(-1, keepdim=True))


def _morton(p: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of points ``p`` (N, 3) in their bounding box."""
    lo, hi = p.min(0), p.max(0)
    q = ((p - lo) / np.maximum(hi - lo, 1e-12) * 1023).astype(np.int64)
    code = np.zeros(len(p), np.int64)
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> bit) & 1) << (3 * bit + (2 - axis))
    return code


class Scene:
    """A parsed scene (``benchmark/scenes``) on ``device``, in ``dtype``."""

    def __init__(self, parsed: dict, device="cpu", dtype=torch.float32):
        self.device, self.dtype = torch.device(device), dtype
        verts = np.asarray(parsed["vertices"], np.float32).reshape(-1, 3)
        faces, fmat = [], []
        for mat, idx in parsed["triangles"]:
            faces.append(np.asarray(idx, np.int64).reshape(1, 3) - 1)
            fmat.append(np.array([mat - 1]))
        for mat, fs in parsed["meshes"]:
            fs = np.asarray(fs, np.int64).reshape(-1, 3) - 1
            faces.append(fs)
            fmat.append(np.full(len(fs), mat - 1))
        faces = np.concatenate(faces) if faces else np.zeros((0, 3), np.int64)
        tri = verts[faces]                                   # (T, 3, 3)
        self.n_tris = len(tri)
        sph = parsed["spheres"]
        self.n_spheres = len(sph)
        mats = parsed["materials"]

        def t(x, dt=dtype):
            return torch.as_tensor(np.asarray(x), device=self.device).to(dt)

        self.tri = t(tri.reshape(-1, 3, 3))
        self.tri_mat = t(np.concatenate(fmat) if fmat else np.zeros(0),
                         torch.int64)
        self.sph_c = t(verts[[s[1] - 1 for s in sph]].reshape(-1, 3))
        self.sph_r = t(np.asarray([s[2] for s in sph], np.float32))
        self.sph_mat = t([s[0] - 1 for s in sph], torch.int64)
        for key in ("ambient", "diffuse", "specular", "mirror"):
            setattr(self, key, t(np.asarray([m[key] for m in mats],
                                            np.float32).reshape(-1, 3)))
        self.phong = t(np.asarray([m["phong"] for m in mats], np.float32))
        self.is_mirror = t([bool(m["is_mirror"]) for m in mats], torch.bool)
        lights = parsed["point_lights"]
        self.light_pos = t(np.asarray([l[0] for l in lights],
                                      np.float32).reshape(-1, 3))
        self.light_int = t(np.asarray([l[1] for l in lights],
                                      np.float32).reshape(-1, 3))
        self.ambient_light = t(np.asarray(parsed["ambient_light"], np.float32))
        self.background = t(np.asarray(parsed["background"], np.float32))
        self.eps = float(np.float32(parsed["shadow_eps"]))
        self.max_depth = int(parsed["max_depth"])
        self._blocks(tri)

    def _blocks(self, tri: np.ndarray) -> None:
        """Culling blocks: Morton-sorted triangle ids (-1 pads the last
        block) and each block's box, padded outward."""
        n = len(tri)
        nb = -(-n // BLOCK)
        order = (np.argsort(_morton(tri.mean(1)), kind="stable")
                 if n else np.zeros(0, np.int64))
        ids = np.full(nb * BLOCK, -1, np.int64)
        ids[:n] = order
        lo = np.full((nb * BLOCK, 3), np.inf, np.float32)
        hi = np.full((nb * BLOCK, 3), -np.inf, np.float32)
        lo[:n], hi[:n] = tri[order].min(1), tri[order].max(1)
        lo, hi = lo.reshape(nb, BLOCK, 3).min(1), hi.reshape(nb, BLOCK, 3).max(1)
        span = float((hi - lo).max()) if nb else 1.0
        pad = 1e-4 * span + 1e-6
        dev = self.device
        self.block_ids = torch.as_tensor(ids.reshape(nb, BLOCK), device=dev)
        self.block_lo = torch.as_tensor(lo - pad, device=dev)
        self.block_hi = torch.as_tensor(hi + pad, device=dev)
        # per triangle, for the pair test: the vertex a, the edges and the
        # cross products of Cramer's determinants (see _tri_pairs)
        a, b, c = (self.tri[:, k] for k in range(3))
        ab, ac = a - b, a - c
        self.tri_terms = (a, ab, ac, _cross(ab, ac), _cross(a, ac),
                          _cross(ab, a))

    # -- visibility --------------------------------------------------------

    def _candidates(self, o, d, t_hi: float) -> torch.Tensor:
        """Triangle ids of every block whose box one of the rays (o + t d,
        0 <= t <= t_hi) enters; computed in float32."""
        o, d = o.float(), d.float()
        inv = 1.0 / torch.where(d == 0, torch.full_like(d, 1e-30), d)
        t0 = (self.block_lo[None] - o[:, None]) * inv[:, None]
        t1 = (self.block_hi[None] - o[:, None]) * inv[:, None]
        near = torch.minimum(t0, t1).amax(-1)
        far = torch.maximum(t0, t1).amin(-1)
        enter = (far >= near.clamp_min(0.0)) & (near <= t_hi)
        blocks = enter.any(0).nonzero().flatten()
        ids = self.block_ids[blocks].flatten()
        return ids[ids >= 0]

    def _tri_pairs(self, o, d, ids):
        """(t, ok) of every ray against triangles ``ids``: (R, K)."""
        a, ab, ac, n, p, q = (x[ids] for x in self.tri_terms)
        x = _cross(d, o)
        feats = torch.cat([d, x, o], -1)                      # (R, 9)
        z = torch.zeros_like(n)
        mats = torch.stack([torch.cat([n, z, z], -1),          # det
                            torch.cat([p, -ac, z], -1),        # beta
                            torch.cat([q, ab, z], -1),         # gamma
                            torch.cat([z, z, n], -1)])         # o . n
        prod = feats @ mats.reshape(-1, 9).T                   # (R, 4K)
        k = ids.shape[0]
        det, bn, gn, on = (prod[:, i * k:(i + 1) * k] for i in range(4))
        inv = 1.0 / det
        beta, gamma = bn * inv, gn * inv
        t = (_dot(a, n)[None] - on) * inv
        ok = ((beta >= 0) & (gamma >= 0) & (1.0 - beta - gamma >= 0)
              & (t >= 0))
        return t, ok

    def _sph_pairs(self, o, d):
        """(t1, ok) of every ray against every sphere: (R, S)."""
        oc = o[:, None] - self.sph_c[None]
        a_q = _dot(d, d)[:, None]
        b_q = 2.0 * _dot(d[:, None], oc)
        c_q = _dot(oc, oc) - (self.sph_r * self.sph_r)[None]
        disc = b_q * b_q - 4.0 * a_q * c_q
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        t1 = (-b_q - sq) / (2.0 * a_q)
        t2 = (-b_q + sq) / (2.0 * a_q)
        return t1, (disc >= 0) & ~((t1 < 0) & (t2 < 0))

    def _chunks(self, r: int, k: int):
        step = max(1, PAIRS // max(r, 1))
        return range(0, k, step), step

    def closest(self, o, d) -> torch.Tensor:
        """Primitive id of each ray's closest hit (-1: none); spheres are
        numbered after the triangles."""
        r = o.shape[0]
        best_t = torch.full((r,), math.inf, device=self.device, dtype=self.dtype)
        best = torch.full((r,), -1, device=self.device, dtype=torch.int64)
        big = torch.iinfo(torch.int64).max
        if self.n_tris:
            ids = self._candidates(o, d, math.inf)
            starts, step = self._chunks(r, ids.shape[0])
            for s in starts:
                sub = ids[s:s + step]
                t, ok = self._tri_pairs(o, d, sub)
                t = torch.where(ok, t, math.inf)
                tv = t.min(1).values
                iv = torch.where(ok & (t == tv[:, None]), sub[None], big).min(1).values
                upd = (tv < best_t) | ((tv == best_t) & (iv < best))
                best_t = torch.where(upd, tv, best_t)
                best = torch.where(upd, iv, best)
        if self.n_spheres:
            t, ok = self._sph_pairs(o, d)
            t = torch.where(ok, t, math.inf)
            tv, iv = t.min(1)
            upd = tv < best_t
            best = torch.where(upd, iv + self.n_tris, best)
            best_t = torch.where(upd, tv, best_t)
        return torch.where(torch.isfinite(best_t), best, -1)

    def occluded(self, o, seg) -> torch.Tensor:
        """Any hit with t < 1 on the segments o -> o + seg."""
        r = o.shape[0]
        occ = torch.zeros((r,), dtype=torch.bool, device=self.device)
        if self.n_tris:
            ids = self._candidates(o, seg, 1.0)
            starts, step = self._chunks(r, ids.shape[0])
            for s in starts:
                t, ok = self._tri_pairs(o, seg, ids[s:s + step])
                occ |= (ok & (t < 1.0)).any(1)
        if self.n_spheres:
            t, ok = self._sph_pairs(o, seg)
            occ |= (ok & (t < 1.0)).any(1)
        return occ

    def surface(self, o, d, prim):
        """(t, normal, material) of each ray on its primitive (hit lanes)."""
        is_tri = prim < self.n_tris
        ti = torch.where(is_tri, prim, 0).clamp(max=max(self.n_tris - 1, 0))
        si = torch.where(is_tri, 0, prim - self.n_tris).clamp(
            0, max(self.n_spheres - 1, 0))
        t = torch.zeros(prim.shape, device=self.device, dtype=self.dtype)
        n = torch.zeros(prim.shape + (3,), device=self.device, dtype=self.dtype)
        mat = torch.zeros(prim.shape, device=self.device, dtype=torch.int64)
        if self.n_tris:
            a, b, c = (self.tri[ti, k] for k in range(3))
            ab, ac, ao = a - b, a - c, a - o
            det = _dot(d, _cross(ab, ac))
            t_tri = _dot(ao, _cross(ab, ac)) / det
            t = torch.where(is_tri, t_tri, t)
            n = torch.where(is_tri[:, None], _normalize(_cross(b - a, c - a)), n)
            mat = torch.where(is_tri, self.tri_mat[ti], mat)
        if self.n_spheres:
            c, rad = self.sph_c[si], self.sph_r[si]
            oc = o - c
            a_q, b_q = _dot(d, d), 2.0 * _dot(d, oc)
            c_q = _dot(oc, oc) - rad * rad
            disc = torch.clamp_min(b_q * b_q - 4.0 * a_q * c_q, 0.0)
            t_s = (-b_q - torch.sqrt(disc)) / (2.0 * a_q)
            p = o + t_s[:, None] * d
            t = torch.where(is_tri, t, t_s)
            n = torch.where(is_tri[:, None], n,
                            _normalize((p - c) / rad[:, None]))
            mat = torch.where(is_tri, mat, self.sph_mat[si])
        return t, n, mat


class Visibility(NamedTuple):
    """What a traced render found, per bounce: the ray rows still active,
    their primitive ids and their occlusion bits (rows, lights)."""
    rows: list
    prim: list
    occ: list


def _grouped(fn, group: int, *xs):
    """``fn`` over consecutive groups of ``group`` rows of ``xs``."""
    n = xs[0].shape[0]
    if n <= group:
        return fn(*xs)
    return torch.cat([fn(*(x[i:i + group] for x in xs))
                      for i in range(0, n, group)])


def render(scene: Scene, origin, dirs, group: int = 1024,
           params: Optional[dict] = None,
           visibility: Optional[Visibility] = None, record: bool = False):
    """Radiance (R, 3) of the rays (origin (3,) or (R, 3), dirs (R, 3)),
    traced in groups of ``group`` consecutive rays.  ``params``
    (``diffuse``, ``light_int``) replace the scene's, with their autograd
    graph; ``visibility``: a recorded trace of the same rays, replayed
    instead of tracing; ``record``: returns (radiance, Visibility)."""
    dt, dev = scene.dtype, scene.device
    params = params or {}
    diffuse = params.get("diffuse", scene.diffuse)
    light_int = params.get("light_int", scene.light_int)
    r = dirs.shape[0]
    cur_d = dirs.to(dt)
    cur_o = origin.to(dt).expand(r, 3)
    color = torch.zeros((r, 3), device=dev, dtype=dt)
    throughput = torch.ones((r, 3), device=dev, dtype=dt)
    rows = torch.arange(r, device=dev)
    seen = Visibility([], [], [])
    nl = scene.light_pos.shape[0]
    for depth in range(scene.max_depth + 1):
        if rows.numel() == 0:
            break
        o, d, tp = cur_o[rows], cur_d[rows], throughput[rows]
        if visibility is not None:
            prim, occ_all = visibility.prim[depth], visibility.occ[depth]
        else:
            with torch.no_grad():
                prim = _grouped(scene.closest, group, o, d)
        hit = prim >= 0
        if depth == 0:
            bg = torch.where(hit[:, None], 0.0, scene.background[None])
            color = color.index_add(0, rows, bg)
        h = hit.nonzero().flatten()
        o, d, tp, prim = o[h], d[h], tp[h], prim[h]
        t, n, mat = scene.surface(o, d, prim)
        point = o + t[:, None] * d
        offset = point + n * scene.eps
        local = scene.ambient[mat] * scene.ambient_light[None]
        d_unit = _normalize(d)
        n_unit = _normalize(n)
        occ_cols = []
        for l in range(nl):
            lp = scene.light_pos[l]
            to_off = lp[None] - offset
            dist = torch.sqrt(_dot(to_off, to_off))
            cos = _dot(_normalize(lp[None] - point), n)
            if visibility is not None:
                occ = occ_all[h, l]
            else:
                # a light behind the surface adds nothing: no shadow test
                occ = torch.ones_like(cos, dtype=torch.bool)
                test = (cos > -1e-3).nonzero().flatten()
                with torch.no_grad():
                    occ[test] = _grouped(scene.occluded, group,
                                         offset[test], to_off[test])
            occ_cols.append(occ)
            irr = light_int[l][None] / (dist * dist)[:, None]
            gate = torch.arccos(cos) * RAD_TO_DEG <= SPEC_GATE_DEG
            cos_h = torch.clamp_min(_dot(n_unit, _normalize(
                to_off / dist[:, None] - d_unit)), 0.0)
            spec = (scene.specular[mat] * torch.pow(cos_h, scene.phong[mat])
                    [:, None] * irr)
            diff = diffuse[mat] * torch.clamp(cos, 0.0, 1.0)[:, None] * irr
            contrib = diff + torch.where(gate[:, None], spec, 0.0)
            local = local + torch.where(occ[:, None], 0.0, contrib)
        color = color.index_add(0, rows[h], tp * local)
        if record:
            full = torch.full((rows.numel(),), -1, device=dev,
                              dtype=torch.int64)
            full[h] = prim
            occ_full = torch.zeros((rows.numel(), nl), dtype=torch.bool,
                                   device=dev)
            if nl:
                occ_full[h] = torch.stack(occ_cols, 1)
            seen.rows.append(rows)
            seen.prim.append(full)
            seen.occ.append(occ_full)
        mirror = scene.is_mirror[mat]
        m = mirror.nonzero().flatten()
        cos_r = -_dot(d_unit[m], n_unit[m])
        refl = d_unit[m] + n_unit[m] * (2.0 * cos_r)[:, None]
        nxt = rows[h][m]
        with torch.no_grad():
            cur_o = cur_o.index_copy(0, nxt, offset[m].detach())
            cur_d = cur_d.index_copy(0, nxt, refl.detach())
        throughput = throughput.index_copy(
            0, nxt, (tp[m] * scene.mirror[mat[m]]).detach())
        rows = nxt
    return (color, seen) if record else color


def quantize(color: torch.Tensor) -> torch.Tensor:
    return torch.floor(torch.clamp(color.float(), 0.0, 255.0) + 0.5).to(
        torch.uint8)


def eye_rays(cam: dict, width: int, height: int, rows, cols, device="cpu",
             dtype=torch.float32):
    """(origin (3,), dirs (N, 3)) through the centres of pixels (rows,
    cols) of ``cam`` at width x height."""
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    e, gaze, v = f(cam["position"]), f(cam["gaze"]), f(cam["up"])
    l, r, b, t = (float(np.float32(x)) for x in cam["near_plane"])
    w = -gaze
    u = _cross(v, w)
    q = e + gaze * float(np.float32(cam["near_distance"])) + u * l + v * t
    su = (cols.float() + 0.5) * ((r - l) / width)
    sv = (rows.float() + 0.5) * ((t - b) / height)
    s = q[None] + u[None] * su[:, None] - v[None] * sv[:, None]
    return e.to(dtype), (s - e[None]).to(dtype)


def tiles_image(scene: Scene, cam: dict, ssaa: int, tiles, tile: int,
                group: int = 1024) -> torch.Tensor:
    """The SSAA-parity uint8 pixels of square output tiles (``tiles``:
    (n, 2) top-left (row, col) of each, ``tile`` pixels a side) of
    ``cam``: (n, tile, tile, 3).  Each tile's rays form its own groups."""
    dev = scene.device
    side = tile * ssaa
    yy, xx = torch.meshgrid(torch.arange(side, device=dev),
                            torch.arange(side, device=dev), indexing="ij")
    tiles = torch.as_tensor(np.asarray(tiles), device=dev).reshape(-1, 2)
    rows = (tiles[:, 0, None] * ssaa + yy.flatten()[None]).flatten()
    cols = (tiles[:, 1, None] * ssaa + xx.flatten()[None]).flatten()
    o, d = eye_rays(cam, cam["width"] * ssaa, cam["height"] * ssaa, rows,
                    cols, dev, scene.dtype)
    q = quantize(render(scene, o, d, group=group))
    q = q.view(-1, tile, ssaa, tile, ssaa, 3).to(torch.int32).sum((2, 4))
    return (q // (ssaa * ssaa)).to(torch.uint8)


def tile_order(height: int, width: int, th: int, tw: int) -> torch.Tensor:
    """Raster indices of a height x width image in th x tw tiles, tile by
    tile, each tile row-major: consecutive rays stay together on screen."""
    idx = torch.arange(height * width).view(height // th, th, width // tw, tw)
    return idx.permute(0, 2, 1, 3).reshape(-1)
