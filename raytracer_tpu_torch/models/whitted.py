"""The Whitted integrator as a bounded-depth wavefront loop (port of
``raytracer_tpu/models/whitted.py``), on the brute, BVH or cluster engine
(``engine="auto"`` picks by accelerator, ``resolve_engine``), forward or
differentiable.

The whole wavefront of rays runs through max_depth+1 lockstep bounces with
a running throughput (the product of mirror tints along the path):

    color     += throughput * local(bounce d)
    throughput *= mat.mirror            (mirror hits only)
    ray        = reflection ray          (others go inactive)

Background only for a depth-0 miss, black for deeper misses; ambient
re-added at every bounce; the loop ends after depth max_depth or when no
lane is active (the differentiable path runs all max_depth + 1 bounces).
On the cluster engine's forward path bounce 0 of an eye wavefront is
peeled out so the closest-hit kernel can use the shared origin, and a
bounce is four kernels around the shortlists (``_fused_bounce``): the
closest kernel, ``cluster_trace.hit_record`` (the hit record and the
shadow mask), the occlusion route, ``cluster_trace.shade_bounce`` (the
shading, the reflection and the carry, written into the wavefront's
buffers).  The brute and BVH engines and every differentiable path
refine their hits and shade with PyTorch ops (``refine_hit``,
``_shade``), which autograd needs.

Cluster-engine shadows: per-light plane tables and the shadow kernel
while a table fits ``SHADOW_PLANES_BYTES_MAX``, else the generic any-hit
kernel (``cluster_any``); brute and bvh take their own any-hit.  Frames
above the ray chunk render chunk by chunk; on the cluster engine rays go
in 8x16 tile order and big scenes cap the chunk
(``_cap_chunk_for_big_scenes``), the other engines trace rays in raster
order.

``render_camera_streamed`` renders row bands of the SSAA-scaled frame and
reduces each band on the device (SSAA, quantization), so ray state stays
about one chunk; it is the route of every render request but adaptive
sampling, jittered sampling included, and over a device mesh it splits
each band's rays into the mesh's shards.

Every forward render of every engine (``render_rays``, ``trace``,
``render_camera``, ``render_band``, ``render_camera_streamed``, on one
device or a mesh) runs one route of program objects: the bounce loop as
steps on static buffers (``_Wavefront``, cut into chunks by ``_Rays``;
the BVH engine's bounce cut at its two walks, whose blocks of iterations
run while their flag reads true), a band or camera as a program around
it (``_Frame``; on a mesh ``_MeshFrame``, its shards ``_Shard``s), the
counterparts of the JAX package's jitted ``_render_rays_jit``,
``_render_band_jit`` (with its ``shard_map``) and
``_render_camera_jit``; the adaptive frame (``ops.adaptive``) and the
training step through the differentiable path (``parallel.train``) are
programs of their own.  ``programs.render_programs`` chooses how they
run: on a CUDA device kept and replayed as CUDA graphs
(``models.programs``); on the CPU, inside ``eager()`` and under
``debug_nans()`` made anew for each render and run in place
(``programs.EAGER``), kept nowhere.

The differentiable path on the BVH engine runs in two passes: a
recording wavefront (``_Wavefront`` with ``record``, no gradient) traces
the visibility of every bounce (primitive ids, occlusion bits), then the
differentiable bounces refine and shade from the recorded visibility, so
that the pass that autograd sees has no host read (``parallel.train``
captures it with the backward and Adam).  Visibility carries no gradient
and autograd does not change forward values: the loss and gradients are
those of one pass.
"""

from __future__ import annotations

import contextlib
import functools
import math

import torch

from raytracer_tpu_torch import tracing
from raytracer_tpu_torch.backend import resolve_device
from raytracer_tpu_torch.models import programs
from raytracer_tpu_torch.models.bvh import DeviceBVH
from raytracer_tpu_torch.models.clusters import ClusterSet
from raytracer_tpu_torch.models.programs import eager  # noqa: F401 (re-export)
from raytracer_tpu_torch.models.scene import Camera, SceneData, SceneMeta
from raytracer_tpu_torch.ops import cluster_trace as ctr
from raytracer_tpu_torch.ops import kernels, shade, traverse
from raytracer_tpu_torch.ops.camera import (
    camera_vectors, draw_jitter, draw_jitter_into, eye_rays_band,
    eye_rays_from, write_jitter_keys,
)
from raytracer_tpu_torch.ops.image import (
    downsample_mean, downsample_parity, quantize,
)
from raytracer_tpu_torch.ops.kernels import TILE
from raytracer_tpu_torch.ops.shade import Hit, refine_hit, shadow_query
from raytracer_tpu_torch.ops.shade import shade_local  # noqa: F401 (re-export)
from raytracer_tpu_torch.ops.tiling import (
    apply_tile_order, block_permutation, divides, undo_tile_order,
)

# Activity compaction (stable sort of the carry, live lanes first) from
# bounce _COMPACT_FROM on, for scenes with max_depth >= _COMPACT_MIN_DEPTH,
# and only when the wave is SCATTERED: live-tile fraction minus active-
# lane fraction above _COMPACT_SCATTER.  The JAX package's gate, kept
# because it decides which rays share a tile (and so, on exact-t ties
# only, which of two equally near primitives wins).
_COMPACT_FROM = 2
_COMPACT_MIN_DEPTH = 3
_COMPACT_SCATTER = 0.15

# the wave counters: ``wave.deep`` samples the rays entering bounce
# _DEEP_FROM or later; a hierarchical scene's running sums and those of a
# scene whose shadow kernel walks sphere clusters
# (``cluster_trace.counting_masks``), in their order in the flags buffer
_DEEP_FROM = 2
_MASK_SAMPLES = ("mask.tiles", "mask.chunks", "lists.tiles", "lists.over")
_SHADOW_SAMPLES = ("shadow.slots", "shadow.live")


# debug_nans(): every wave's radiance is checked after each bounce
_debug = {"nans": False}


@contextlib.contextmanager
def debug_nans(on: bool = True):
    """Inside the block (``--debug-nans``) the radiance of every wave is
    checked after each bounce, one device sync a bounce, and a value that
    is not finite raises FloatingPointError naming the bounce (and the
    band or adaptive wave); the renders and training steps run eagerly
    (``programs.eager()``), and the autograd anomaly mode is on, so a
    differentiable render's backward names the forward op behind a NaN.
    The port's counterpart of the JAX package's ``jax_debug_nans``, not
    the same switch: that one checks the output of every op."""
    prev = _debug["nans"]
    _debug["nans"] = on
    try:
        with torch.autograd.set_detect_anomaly(on), (
                programs.eager() if on else contextlib.nullcontext()):
            yield
    finally:
        _debug["nans"] = prev


@contextlib.contextmanager
def nan_site(where: str):
    """Prefix ``where`` to a FloatingPointError of ``debug_nans`` raised
    inside the block."""
    try:
        yield
    except FloatingPointError as e:
        raise FloatingPointError(f"{where}: {e}") from None


def _compact_carry(carry):
    """Stably sort the bounce carry by activity: live lanes first; ``idx``
    records the permutation."""
    depth, color, throughput, active, org, dirs, idx = carry
    perm = torch.argsort((~active).to(torch.int32), stable=True)
    return (depth, color[perm], throughput[perm], active[perm], org[perm],
            dirs[perm], idx[perm])


def _uncompact_color(color, idx):
    """Restore accumulated radiance to original ray order (sort by idx)."""
    return color[torch.argsort(idx, stable=True)]


def resolve_engine(engine: str, accel, meta: SceneMeta) -> str:
    """``auto``: a ClusterSet gives cluster, another accelerator over a
    scene of more than 64 primitives gives bvh, else brute; the other
    names are checked and returned."""
    if engine == "auto":
        if isinstance(accel, ClusterSet):
            return "cluster"
        if accel is not None and meta.n_tris + meta.n_spheres > 64:
            return "bvh"
        return "brute"
    if engine not in traverse.ENGINES:
        raise ValueError(f"unknown engine {engine!r}; auto or one of "
                         f"{traverse.ENGINES}")
    return engine


def _occlusion(data: SceneData, meta: SceneMeta, accel, engine: str,
               bfc: bool, relaxed: bool):
    """(shadow_fn, shadow_multi_fn, occluded_fn) for ``shade_local``: on
    the cluster engine per-light plane tables and the shadow kernel while
    a table fits ``SHADOW_PLANES_BYTES_MAX`` (all lights in one launch
    while every table fits together), else the engine's any-hit."""
    nl = meta.n_lights
    shadow_fn = shadow_multi_fn = None

    # small_spheres (cluster engine): False leaves out the dense test of a
    # scene's few spheres, which the forward bounce's kernel makes
    def occluded_fn(org, seg, t_max, mask, small_spheres=True):
        return traverse.any_hit(data, org, seg, t_max, accel, engine,
                                active=mask, bfc=bfc, relaxed=relaxed,
                                small_spheres=small_spheres)

    if engine == "cluster" and nl > 0:
        pt = accel.tri_verts.shape[1]
        if pt * 64 <= ctr.SHADOW_PLANES_BYTES_MAX:
            planes = [ctr.build_shadow_planes(accel, data.light_pos[l], bfc=bfc)
                      for l in range(nl)]

            def shadow_fn(org, sdir, mask, l, small_spheres=True):
                return ctr.cluster_shadow(accel, planes[l], org, sdir,
                                          data.light_pos[l], active=mask,
                                          relaxed=relaxed,
                                          small_spheres=small_spheres)

            # all lights in ONE kernel launch while every table fits together
            if nl >= 2 and nl * pt * 64 <= ctr.SHADOW_PLANES_BYTES_MAX:
                def shadow_multi_fn(org, masks, small_spheres=True):
                    return ctr.cluster_shadow_multi(
                        accel, planes, org, data.light_pos[:nl], masks,
                        relaxed=relaxed, small_spheres=small_spheres)
    return shadow_fn, shadow_multi_fn, occluded_fn


def _bounce(data: SceneData, meta: SceneMeta, accel, engine: str, bfc: bool,
            fns, carry, prim=None):
    """One bounce of the carry (depth, color, throughput, active, cur_org,
    cur_dir, idx), differentiable; ``depth`` is a Python int.  The
    engine's primitive ids (``prim``, when given: recorded ones) are
    refined (``refine_hit``) and shaded by ``_shade``.  The cluster
    engine's forward bounces take ``_fused_bounce``."""
    depth, color, throughput, active, cur_org, cur_dir, idx = carry
    if prim is None:
        prim = traverse.closest_hit(data, cur_org, cur_dir, accel, engine,
                                    active=active, bfc=bfc)
    prim = torch.where(active, prim, traverse.MISS)
    h = refine_hit(data, meta, cur_org, cur_dir, prim)
    return _shade(data, meta, fns, carry, h)


def _fused_bounce(data: SceneData, meta: SceneMeta, accel, bfc: bool, fns,
                  carry, shared, relaxed: bool, out):
    """The cluster engine's forward bounce of the carry (as ``_bounce``'s):
    the closest kernel (``cluster_trace.cluster_closest_slots``; from the
    ``shared`` (3,) origin when given), the hit record
    (``cluster_trace.hit_record``), the occlusion route of ``fns`` without
    its small-sphere test, then the shading and the next carry
    (``cluster_trace.shade_bounce``, ``relaxed`` its sphere test's, into
    the buffers ``out``)."""
    depth, color, throughput, active, cur_org, cur_dir, idx = carry
    org = cur_org if shared is None else shared
    t, slot = ctr.cluster_closest_slots(accel, org, cur_dir, active=active,
                                        bfc=bfc,
                                        shared_origin=shared is not None)
    h, mask = ctr.hit_record(data, meta, accel, t, slot, org, cur_dir, active)
    occ = _occluded(data, meta, fns, h.offset, mask)
    color, throughput, active, cur_org, cur_dir = ctr.shade_bounce(
        data, meta, accel, (color, throughput, active, org, cur_dir), h, occ,
        depth == 0, relaxed, out=out)
    _check_radiance(color, depth)
    return depth + 1, color, throughput, active, cur_org, cur_dir, idx


def _occluded(data: SceneData, meta: SceneMeta, fns, offset, mask):
    """(R, L) occlusion of the segments from the offset points to each
    light where ``mask`` (hit and relevant), through the route of ``fns``
    (``_occlusion``) without its small-sphere test; None without lights."""
    nl = meta.n_lights
    if nl == 0:
        return None
    shadow_fn, shadow_multi_fn, occluded_fn = fns
    if shadow_multi_fn is not None:
        return shadow_multi_fn(offset, mask, small_spheres=False)
    if shadow_fn is not None:
        return torch.stack([
            shadow_fn(offset, data.light_pos[l] - offset, mask[:, l], l,
                      small_spheres=False)
            for l in range(nl)], dim=1)
    to_off = data.light_pos[:nl][None, :, :] - offset[:, None, :]
    return occluded_fn(*shade.segments(offset, to_off, mask),
                       small_spheres=False).reshape(nl, -1).T.contiguous()


def _check_radiance(color, depth: int) -> None:
    if _debug["nans"] and not bool(torch.isfinite(color).all()):
        raise FloatingPointError(f"radiance not finite after bounce {depth}")


def _shade(data: SceneData, meta: SceneMeta, fns, carry, h: Hit):
    """The rest of a bounce from its hits ``h`` (``shade.bounce``: the
    background of a depth-0 miss, the local shading, occlusion through
    ``fns``, the mirror reflection); returns the next carry."""
    depth, idx = carry[0], carry[-1]
    color, throughput, active, cur_org, cur_dir = shade.bounce(
        data, meta, carry[1:6], h, depth == 0, fns=fns)
    _check_radiance(color, depth)
    return depth + 1, color, throughput, active, cur_org, cur_dir, idx


class _Wavefront:
    """The forward bounce loop over ``r`` rays on ``engine`` (the path of
    ``render_rays`` without ``differentiable``) as program steps on
    static buffers: the inputs ``origin`` ((3,) shared, or (r, 3)) and
    ``dirs``; the carry (``color``, ``throughput``, ``active``,
    ``cur_org``, ``cur_dir``, ``idx``), which each bounce rewrites in
    place; and ``flags``, written at the end of every bounce but the last:
    the rays still active, the live 128-ray tiles (the cluster engine's;
    0 on brute and bvh) and the compaction gate of the next bounce, in the
    float ops of the JAX package's gate (the cluster engine's; off for
    brute and bvh, whose hits are refined from ids, as in the JAX
    package).  ``run`` reads the flags once between bounces, as XLA's
    while_loop reads its predicate, so the early exit (no ray active) and
    both branches of the gate stay: each bounce runs exactly the ops of
    the JAX package's loop.  While a profiler records, ``run`` samples
    (``tracing.sample``) each bounce's ``wave.active``, the rays active
    entering it, and on the cluster engine ``wave.lanes``, 128 x the live
    tiles its kernels see (after a compaction's sort ceil(active / 128));
    from bounce _DEEP_FROM on, ``wave.deep``, the same active rays; after
    a bounce whose step went through ``_fused_bounce`` (``fused``, noted
    as the body runs), ``wave.fused``, its active rays again.  On a scene
    whose masks take the hierarchical route
    (``cluster_trace.hierarchical``) ``flags`` holds four running sums
    more, ``masks``, which every bounce's mask calls and shortlist
    compactions add to (``cluster_trace.counting_masks``): the masks'
    active tiles and the live (tile, chunk) pairs of their supercluster
    pass, the shortlists with a candidate and those past their cap; on a
    scene whose shadow kernel walks sphere clusters (more than
    ``SMALL_SPH`` spheres) two more, ``shadow_sums``, which every shadow
    kernel call adds to: 128 for each (tile, light) whose sphere walk
    runs, and that walk's live rays.  At each read in a sampled run the
    host samples what they grew by since its last read (``mask.tiles``,
    ``mask.chunks``, ``lists.tiles``, ``lists.over``, ``shadow.slots``,
    ``shadow.live``); a run's last bounce, which no read follows, is
    counted at the next run's first, so a stretch of sampled runs loses
    only its final bounce, and no read or sync is added.

    Steps: bounce 0 (on the cluster engine the shared-eye peel for a
    shared origin), bounce d plain or compacting (from _COMPACT_FROM), and
    ``uncompact`` after a run whose carry was permuted (the host knows
    whether one was; idx is arange otherwise).  Which of them a run takes
    follows its rays (a camera sweep flips the compaction gate, or lets a
    bounce's rays run out), so a kept wavefront (``warm``: brute and
    cluster) makes them all before its first run (``_warm``): no later
    run captures.  A BVH bounce is cut at its
    two walks (``traverse.Walk``, static state of r and L*r lanes): the
    closest walk's set-up; its blocks; the hits (``refine_hit``, kept in
    the static ``hit``) and the shadow walk's set-up (``shadow_query``);
    its blocks; the shading, the reflection and the flags.  A walk's block
    is one step shared by every bounce, replayed while its flag reads
    true.  ``record`` (BVH, the differentiable path's visibility pass):
    every bounce runs, no early exit, and each writes its primitive ids
    into ``ids[d]`` and its occlusion bits into ``occ[d]``.

    ``step(name, body)`` makes each step: captured
    (``programs.Programs.step``) or run in place (``programs.EAGER``).
    The steps are kept per bounce, their bodies bound methods of the
    wavefront or partials of them."""

    def __init__(self, data: SceneData, meta: SceneMeta, accel, r: int,
                 shared: bool, bfc: bool, relaxed: bool, compact_mode: str,
                 device, step, engine: str = "cluster", record: bool = False,
                 warm: bool = False):
        self.data, self.meta, self.accel, self.bfc = data, meta, accel, bfc
        self.r, self.shared, self.engine, self.record = r, shared, engine, record
        self.warm = warm and engine != "bvh"
        self.relaxed = relaxed
        self.compact = (engine == "cluster"
                        and (meta.max_depth >= _COMPACT_MIN_DEPTH
                             or compact_mode == "deep") and r % TILE == 0)
        self.fns = _occlusion(data, meta, accel, engine, bfc, relaxed)
        f32 = dict(dtype=torch.float32, device=device)
        self.origin = torch.zeros((3,) if shared else (r, 3), **f32)
        self.dirs = torch.zeros((r, 3), **f32)
        self.color = torch.zeros((r, 3), **f32)
        self.throughput = torch.zeros((r, 3), **f32)
        self.cur_org = torch.zeros((r, 3), **f32)
        self.cur_dir = torch.zeros((r, 3), **f32)
        self.active = torch.zeros((r,), dtype=torch.bool, device=device)
        self.idx = torch.arange(r, device=device)
        counted = engine == "cluster" and not record
        hier = counted and ctr.hierarchical(accel)
        spheres = (counted and self.fns[0] is not None
                   and accel.n_sph > ctr.SMALL_SPH)
        self.sums = (_MASK_SAMPLES if hier else ()) + (
            _SHADOW_SAMPLES if spheres else ())
        self.flags = torch.zeros((3 + len(self.sums),), dtype=torch.int64,
                                 device=device)
        n_masks = len(_MASK_SAMPLES) if hier else 0
        self.masks = self.flags[3:3 + n_masks] if hier else None
        self.shadow_sums = self.flags[3 + n_masks:] if spheres else None
        # the running sums ``sums`` at the last sampled read
        self.masks_seen = [0] * len(self.sums)
        nl, i64 = meta.n_lights, dict(dtype=torch.int64, device=device)
        if engine == "bvh":
            bvh = traverse._device_bvh(accel)
            self.walks = [traverse.Walk(data, bvh, r, True, bfc, device)]
            if nl:
                self.walks.append(traverse.Walk(data, bvh, nl * r, False, bfc,
                                                device))
            self.hit = Hit(
                hit=torch.zeros((r,), dtype=torch.bool, device=device),
                t=torch.zeros((r,), **f32), normal=torch.zeros((r, 3), **f32),
                mat=torch.zeros((r,), **i64), point=torch.zeros((r, 3), **f32),
                offset=torch.zeros((r, 3), **f32))
        elif record:
            raise ValueError("only the bvh engine records its visibility")
        if record:
            self.ids = torch.zeros((meta.max_depth + 1, r), **i64)
            self.occ = (torch.zeros((meta.max_depth + 1, nl * r),
                                    dtype=torch.bool, device=device)
                        if nl else None)
        self.step = step
        self.steps = {}
        self.blocks = {}
        self.fused = set()   # the (depth, compacted) steps of _fused_bounce

    @torch.no_grad()
    def load(self, origin, dirs) -> None:
        self.origin.copy_(origin)
        self.dirs.copy_(dirs)

    @torch.no_grad()
    def run(self) -> torch.Tensor:
        """Trace the loaded rays; returns the ``color`` buffer (R, 3)."""
        if self.warm:
            self._warm()
        sampled = not self.record and tracing.recording()
        if sampled:
            self._sample(self.r, -(-self.r // TILE))
        else:
            self.masks_seen = None
        self._run(0, False)
        if sampled:
            self._sample_fused((0, False), self.r)
        compacted = False
        for depth in range(1, self.meta.max_depth + 1):
            take = False
            if not self.record:
                active, tiles, scattered, *masks = programs.read_flags(
                    self.flags)
                if sampled and masks:
                    self._sample_masks(masks)
                if not active:
                    break
                take = (self.compact and depth >= _COMPACT_FROM
                        and scattered > 0)
                if sampled:
                    self._sample(active, -(-active // TILE) if take else tiles)
                    if depth >= _DEEP_FROM:
                        tracing.sample("wave.deep", active)
            self._run(depth, take)
            if sampled:
                self._sample_fused((depth, take), active)
            compacted |= take
        if compacted:
            self._run("uncompact", True)
        return self.color

    def _warm(self) -> None:
        """Every step past bounce 0, made before the first run: each depth
        on each side of the compaction gate, and ``uncompact``.  Each runs
        once on the buffers as they are, no ray active (its first, eager
        run; bounce 0 rewrites every buffer), and is captured; the kernels
        they launch are set-up, not counted in ``kernels.launches``."""
        self.warm = False
        launches = dict(kernels.launches)
        for depth in range(1, self.meta.max_depth + 1):
            self._run(depth, False)
            if self.compact and depth >= _COMPACT_FROM:
                self._run(depth, True)
        if self.compact:
            self._run("uncompact", True)
        kernels.launches.update(launches)

    def _sample(self, active: int, tiles: int) -> None:
        tracing.sample("wave.active", active)
        if self.engine == "cluster":
            tracing.sample("wave.lanes", TILE * tiles)

    def _sample_masks(self, masks: list) -> None:
        """``sums``: what the running sums ``masks`` (as read) grew by
        since the last sampled read; the first read after an unsampled run
        only sets the base."""
        seen, self.masks_seen = self.masks_seen, masks
        if seen is not None:
            for name, now, then in zip(self.sums, masks, seen):
                tracing.sample(name, now - then)

    def _sample_fused(self, key, active: int) -> None:
        """``wave.fused``: the bounce's ``active`` rays, where its step
        (``key``) went through ``_fused_bounce``."""
        if key in self.fused:
            tracing.sample("wave.fused", active)

    def _run(self, depth, compacted: bool) -> None:
        steps = self.steps.get((depth, compacted))
        if steps is None:
            steps = self.steps[(depth, compacted)] = [
                self._walk(p) if isinstance(p, int) else self.step(*p)
                for p in self._parts(depth, compacted)]
        for step in steps:
            step()

    def _parts(self, depth, compacted: bool) -> list:
        """The (name, body) steps of bounce ``depth``, a walk's index where
        its blocks run."""
        if depth == "uncompact":
            return [("uncompact", self._uncompact)]
        if self.engine != "bvh":
            name = f"bounce {depth}" + (", compacted" if compacted else "")
            return [(name, functools.partial(self._bounce_step, depth,
                                             compacted))]
        parts = [(f"bounce {depth} closest set-up",
                  functools.partial(self._bvh_closest, depth)), 0,
                 (f"bounce {depth} shadow set-up",
                  functools.partial(self._bvh_shadows, depth))]
        if len(self.walks) > 1:
            parts.append(1)
        return parts + [(f"bounce {depth} shading",
                         functools.partial(self._bvh_shade, depth))]

    def _walk(self, i: int):
        """Runs walk ``i``'s blocks: its one block step, kept."""
        walk = self.walks[i]
        if i not in self.blocks:
            self.blocks[i] = self.step(f"{('closest', 'shadow')[i]} walk "
                                       "block", walk.block)
        block = self.blocks[i]
        return lambda: walk.run(block)

    def _carry(self, depth: int):
        """The carry entering bounce ``depth``: the loaded rays at 0, else
        the buffers (``_buffers``)."""
        if depth == 0:
            r, dev = self.r, self.dirs.device
            return (0, torch.zeros((r, 3), dtype=torch.float32, device=dev),
                    torch.ones((r, 3), dtype=torch.float32, device=dev),
                    torch.ones((r,), dtype=torch.bool, device=dev),
                    self.origin.expand(r, 3), self.dirs,
                    torch.arange(r, device=dev) if self.compact else self.idx)
        return self._buffers(depth)

    def _buffers(self, depth: int):
        return (depth, self.color, self.throughput, self.active, self.cur_org,
                self.cur_dir, self.idx)

    def _store(self, carry) -> None:
        """The carry's tensors into the buffers."""
        _, color, throughput, active, cur_org, cur_dir, idx = carry
        for buf, x in ((self.color, color), (self.throughput, throughput),
                       (self.active, active), (self.cur_org, cur_org),
                       (self.cur_dir, cur_dir), (self.idx, idx)):
            if x is not buf:
                buf.copy_(x)

    def _flags(self, depth: int, active) -> None:
        if depth < self.meta.max_depth:
            count = active.sum()
            tiles = scattered = torch.zeros_like(count)
            if self.engine == "cluster":
                pad = (-self.r) % TILE   # the kernels pad with inactive rays
                live = (torch.nn.functional.pad(active, (0, pad)) if pad
                        else active).reshape(-1, TILE).any(1)
                tiles = live.sum()
                if self.compact and depth + 1 >= _COMPACT_FROM:
                    act_f = active.to(torch.float32).mean()
                    live_f = live.to(torch.float32).mean()
                    scattered = live_f - act_f > _COMPACT_SCATTER
            self.flags[:3].copy_(torch.stack([count, tiles, scattered]))

    def _bounce_step(self, depth: int, compacted: bool) -> None:
        carry = self._carry(depth)
        if compacted:
            carry = _compact_carry(carry)
        if self.engine == "cluster":
            shared = self.origin if depth == 0 and self.shared else None
            with ctr.counting_masks(self.masks, self.shadow_sums):
                carry = _fused_bounce(self.data, self.meta, self.accel,
                                      self.bfc, self.fns, carry, shared,
                                      self.relaxed, self._buffers(depth)[1:6])
            self.fused.add((depth, compacted))
        else:
            carry = _bounce(self.data, self.meta, self.accel, self.engine,
                            self.bfc, self.fns, carry)
        self._store(carry)
        self._flags(depth, carry[3])

    def _bvh_closest(self, depth: int) -> None:
        if depth == 0:
            self._store(self._carry(0))
        self.walks[0].start(self.cur_org, self.cur_dir, self.active)

    def _bvh_shadows(self, depth: int) -> None:
        prim = torch.where(self.active, self.walks[0].best_p, traverse.MISS)
        # shade's own binding: this module's refine_hit is the one the
        # differentiable bounces call (a check that spies on it counts
        # those, not a recording pass's)
        h = shade.refine_hit(self.data, self.meta, self.cur_org,
                             self.cur_dir, prim)
        for buf, x in zip(self.hit, h):
            buf.copy_(x)
        if self.record:
            self.ids[depth].copy_(prim)
        if len(self.walks) > 1:
            org, seg, t_max, mask = shadow_query(self.data, self.meta, h)
            self.walks[1].start(org, seg, mask, t_max)

    def _bvh_shade(self, depth: int) -> None:
        occ = self.walks[1].done if len(self.walks) > 1 else None
        if self.record and occ is not None:
            self.occ[depth].copy_(occ)
        carry = _shade(self.data, self.meta, (None, None, lambda *a: occ),
                       self._buffers(depth), self.hit)
        self._store(carry)
        self._flags(depth, carry[3])

    def _uncompact(self) -> None:
        self.color.copy_(_uncompact_color(self.color, self.idx))


def _wavefront(progs, data, meta, accel, r: int, shared: bool, bfc: bool,
               relaxed: bool, compact_mode: str, device,
               engine: str = "cluster") -> _Wavefront:
    """The wavefront program of this engine and shape from ``progs``
    (``programs.render_programs``): the scene's kept one, or a new one."""
    args = (data, meta, accel, r, shared, bfc, relaxed, compact_mode, device)
    return progs.program(("rays", engine, r, shared, bfc, relaxed,
                          compact_mode),
                         lambda: _Wavefront(*args, progs.step, engine,
                                            warm=progs is not programs.EAGER))


def _check_compact_mode(compact_mode: str) -> None:
    if compact_mode not in ("auto", "deep"):
        raise ValueError(f"unknown compact_mode {compact_mode!r}")


def _visibility(data, meta, accel, origin, dirs, bfc: bool):
    """The BVH engine's visibility of the differentiable path's bounces,
    traced eagerly by a recording wavefront (no gradient): (ids (D+1, R),
    occ (D+1, L*R) or None without lights)."""
    wf = _Wavefront(data, meta, accel, dirs.shape[0], origin.dim() == 1, bfc,
                    False, "auto", dirs.device, programs.EAGER.step, "bvh",
                    record=True)
    wf.load(origin.detach(), dirs.detach())
    wf.run()
    return wf.ids, wf.occ


def render_rays(data: SceneData, meta: SceneMeta, origin, dirs, accel,
                engine: str = "cluster", differentiable: bool = False,
                bfc: bool = False, relaxed: bool = False,
                compact_mode: str = "auto", visibility=None):
    """(R, 3) f32 radiance of a wavefront.  ``origin``: (3,) (a shared eye
    point) or (R, 3); ``dirs``: (R, 3), unnormalized (the camera's).
    ``accel``: the engine's accelerator (a ClusterSet, a DeviceBVH, None
    for brute).

    ``differentiable``: the hits are re-derived from the engine's
    primitive ids by ``refine_hit`` (gradients flow into the scene
    tensors), in exactly max_depth + 1 bounces: no early exit, no
    compaction, no peeled eye bounce.  On the BVH engine the ids and the
    occlusion bits come from ``visibility`` ((ids, occ) of a recording
    ``_Wavefront``), traced first (``_visibility``) when not given.
    Otherwise the rays are ``trace``'s one wavefront (``_Wavefront``, the
    program of this scene, engine and shape, ``programs``): the cluster
    engine takes its hits from the kernel's slot table, brute and bvh
    refine their ids the same way, stopping once no ray is active.  The
    cluster engine's shadow kernels (plane tables within
    ``SHADOW_PLANES_BYTES_MAX``) serve both paths.
    ``compact_mode`` (fast path only): ``auto`` gates the activity
    compaction off below max depth _COMPACT_MIN_DEPTH; ``deep`` keeps only
    the runtime scatter gate (adaptive refinement waves, scattered by
    construction)."""
    r, dev = dirs.shape[0], dirs.device
    if not differentiable:
        return trace(data, meta, origin, dirs, accel, r, bfc=bfc,
                     relaxed=relaxed, compact_mode=compact_mode, engine=engine)
    _check_compact_mode(compact_mode)
    if engine == "bvh" and visibility is None:
        visibility = _visibility(data, meta, accel, origin, dirs, bfc)
    fns = _occlusion(data, meta, accel, engine, bfc, relaxed)
    carry = (
        0,
        torch.zeros((r, 3), dtype=torch.float32, device=dev),
        torch.ones((r, 3), dtype=torch.float32, device=dev),
        torch.ones((r,), dtype=torch.bool, device=dev),
        origin.expand(r, 3),
        dirs,
        torch.arange(r, device=dev),
    )
    for depth in range(meta.max_depth + 1):
        prim = None
        if visibility is not None:
            ids, occ = visibility
            prim = ids[depth]
            if occ is not None:
                fns = (None, None, lambda *a, o=occ[depth]: o)
        carry = _bounce(data, meta, accel, engine, bfc, fns, carry, prim=prim)
    return carry[1]


def _tile_block_shape():
    """(bh, bw) pixel block holding exactly TILE rays (8x16 for 128)."""
    bh = 1 << (max(TILE.bit_length() - 1, 0) // 2)
    return bh, TILE // bh


# scenes with more triangle or sphere slots than this render in chunks
# of at most _BIG_SCENE_CHUNK rays (the JAX package's segmentation
# threshold; the port does not segment)
SEG_SLOTS = 128 * 1024
_BIG_SCENE_CHUNK = 1 << 17


def _cap_chunk_for_big_scenes(chunk: int, accel) -> int:
    """Cap the ray chunk of cluster scenes beyond SEG_SLOTS slots at
    131,072 rays (1,024 tiles), as the JAX package does.  Its reason was
    its compile service; here it bounds the glue's dense (tiles, clusters)
    and (tiles, clusters, 3) temporaries, which grow with both.  Any other
    accelerator keeps ``chunk``."""
    if isinstance(accel, ClusterSet) and (
            accel.tri_dat.shape[1] > SEG_SLOTS
            or accel.sph_dat.shape[1] > SEG_SLOTS):
        return min(chunk, _BIG_SCENE_CHUNK)
    return chunk


def _render_device(data: SceneData, accel, device) -> torch.device:
    """The render's device (CUDA by default; raises without a GPU), which
    must hold the scene and the accelerator (a ClusterSet, a DeviceBVH or
    None)."""
    dev = resolve_device(device)
    where = {"scene": data.device}
    if isinstance(accel, ClusterSet):
        where["clusters"] = accel.tri_dat.device
    elif isinstance(accel, DeviceBVH):
        where["bvh"] = accel.skip.device
    elif accel is not None:
        raise ValueError("the bvh engine walks a DeviceBVH "
                         "(models.bvh.device_bvh)")
    if any(d != dev for d in where.values()):
        raise ValueError(", ".join(f"{k} on {d}" for k, d in where.items())
                         + f"; render on {dev}")
    return dev


def _tile_order(h: int, w: int, dev, engine: str = "cluster"):
    """(blocks, perm, inv) of ``apply_tile_order`` for an (h, w) ray grid:
    for the cluster engine 8x16 blocks by reshape when they divide it,
    else a permutation; raster order (all None) for the other engines."""
    if engine != "cluster":
        return None, None, None
    bh, bw = _tile_block_shape()
    if divides(h, w, bh, bw):
        return (bh, bw), None, None
    p, i = block_permutation(h, w, bh, bw)
    return None, torch.from_numpy(p).to(dev), torch.from_numpy(i).to(dev)


def _chunks(r: int, chunk: int):
    """(rays a wavefront, wavefronts, pad rays) of ``trace`` over r rays:
    one wavefront of r when r <= ``chunk``, else ``chunk`` rounded down to
    whole tiles, the last padded."""
    if r <= chunk:
        return r, 1, 0
    c = max(TILE, (chunk // TILE) * TILE)
    pad = (-r) % c
    return c, (r + pad) // c, pad


def trace(data: SceneData, meta: SceneMeta, origin, dirs, accel,
          chunk: int, bfc: bool = False, relaxed: bool = False,
          compact_mode: str = "auto", engine: str = "cluster"):
    """(R, 3) radiance of rays (``origin`` (3,) shared or (R, 3) per ray;
    in tile order for the cluster engine), traced by a ``_Rays`` of the
    render's programs (``programs.render_programs``): one wavefront when
    R <= ``chunk``, else wavefronts of ``chunk`` rays rounded down to
    whole tiles, the last padded with copies of the last ray."""
    _check_compact_mode(compact_mode)
    dev = dirs.device
    rays = _Rays(programs.render_programs(data, meta, accel, dev), data, meta,
                 accel, dirs.shape[0], chunk, origin.dim() == 1, bfc, relaxed,
                 compact_mode, dev, engine)
    rays.load(origin, dirs)
    rays.run()
    return rays.color.clone()


def render_camera(data: SceneData, meta: SceneMeta, cam: Camera, accel,
                  chunk: int = 1 << 22, bfc: bool = False,
                  relaxed: bool = False, device="cuda", engine: str = "auto"):
    """Render one camera to an (H, W, 3) f32 radiance image on ``device``
    (CUDA by default; raises without a GPU) through ``engine``
    (``resolve_engine``).  On the cluster engine rays are reordered into
    8x16 pixel blocks so every kernel tile is a coherent frustum.  A frame
    of at most ``chunk`` rays (capped for big cluster scenes) is one
    wavefront; larger frames render chunk by chunk: whole tiles, the last
    chunk padded with copies of the last ray.  The frame is the camera's
    ``_Frame`` of the render's programs (``programs.render_programs``)."""
    dev = _render_device(data, accel, device)
    engine = resolve_engine(engine, accel, meta)
    h, w = cam.height, cam.width
    chunk = _cap_chunk_for_big_scenes(max(TILE, (chunk // TILE) * TILE),
                                      accel)
    vec = torch.from_numpy(camera_vectors(cam)).to(dev)
    progs = programs.render_programs(data, meta, accel, dev)
    return _frame(progs, data, meta, accel, "camera", h, w, h, chunk, 1,
                  "parity", True, False, bfc, relaxed, engine)(vec).clone()


def render_band(data: SceneData, meta: SceneMeta, accel, vec,
                hs: int, ws: int, row0: int, bh: int, *, ssaa: int,
                ssaa_mode: str, hdr: bool, chunk: int, jitter=None,
                bfc: bool = False, relaxed: bool = False,
                engine: str = "cluster", mesh=None):
    """Rows [row0, row0+bh) of the (hs, ws) SSAA-scaled frame: eye rays
    (offset by ``jitter``, (bh, ws, 2), when given), in tile order for the
    cluster engine, traced, back in row order, then reduced on the device:
    ``hdr`` f32 radiance (SSAA as a float mean), else uint8 (SSAA parity:
    quantize, then the truncating mean; otherwise the float mean, then
    quantize).  The band is the ``_Frame`` of the render's programs
    (``programs.render_programs``); with ``mesh``
    (``parallel.mesh.Mesh``) the ``_MeshFrame``, whose tile-ordered rays
    are traced shard by shard and gathered across processes, everything
    around the trace the same code, so the band is the same bit for bit
    (bh must hold whole blocks per shard, ``render_camera_streamed``)."""
    progs = programs.render_programs(data, meta, accel, vec.device)
    return _frame(progs, data, meta, accel, "band", hs, ws, bh, chunk, ssaa,
                  ssaa_mode, hdr, jitter is not None, bfc, relaxed, engine,
                  mesh)(vec, row0, jitter).clone()


def _band_image(color, bh: int, ws: int, blocks, inv, ssaa: int,
                ssaa_mode: str, hdr: bool):
    """A band's radiance (bh*ws, 3) in tile order -> its image: row order,
    then ``hdr`` f32 radiance (SSAA as a float mean), else uint8 (SSAA
    parity: quantize, then the truncating mean; otherwise the float mean,
    then quantize)."""
    color = undo_tile_order(color, bh, ws, blocks, inv).reshape(bh, ws, 3)
    if hdr:
        return color if ssaa <= 1 else downsample_mean(color, ssaa)
    if ssaa <= 1:
        return quantize(color)
    if ssaa_mode == "parity":
        return downsample_parity(quantize(color), ssaa)
    return quantize(downsample_mean(color, ssaa))


class _Rays:
    """A wavefront program over ``r`` rays (``shared``: one (3,) origin,
    else one a ray) on ``engine``, cut into chunks as ``trace`` cuts them
    (``_chunks``): one ``_Wavefront`` of r rays, or of ``chunk`` rays
    rounded down to whole tiles run chunk by chunk over ``dirs_all`` (and
    ``origin_all``), the rays padded with copies of the last one, into
    ``color_all``.  ``load`` (inside a step's body) copies the rays in,
    ``run`` traces them, ``color`` is the (r, 3) radiance buffer."""

    def __init__(self, progs, data: SceneData, meta: SceneMeta, accel, r: int,
                 chunk: int, shared: bool, bfc: bool, relaxed: bool,
                 compact_mode: str, device, engine: str = "cluster"):
        self.r = r
        c, self.n, pad = _chunks(r, chunk)
        self.wf = _wavefront(progs, data, meta, accel, c, shared, bfc, relaxed,
                             compact_mode, device, engine)
        self.whole = self.n == 1 and pad == 0
        if not self.whole:
            f32 = dict(dtype=torch.float32, device=device)
            self.dirs_all = torch.zeros((self.n * c, 3), **f32)
            self.origin_all = (None if shared
                               else torch.zeros((self.n * c, 3), **f32))
            self.color_all = torch.zeros((self.n * c, 3), **f32)

    @torch.no_grad()
    def load(self, origin, dirs) -> None:
        if self.whole:
            self.wf.load(origin, dirs)
            return
        if self.origin_all is None:
            self.wf.origin.copy_(origin)
        for buf, x in ((self.dirs_all, dirs), (self.origin_all, origin)):
            if buf is not None:
                buf[:self.r].copy_(x)
                buf[self.r:].copy_(x[-1:].expand(buf.shape[0] - self.r, 3))

    @torch.no_grad()
    def run(self) -> None:
        wf = self.wf
        if self.whole:
            wf.run()
            return
        for i in range(self.n):
            rows = slice(i * wf.r, (i + 1) * wf.r)
            wf.dirs.copy_(self.dirs_all[rows])
            if self.origin_all is not None:
                wf.origin.copy_(self.origin_all[rows])
            self.color_all[rows].copy_(wf.run())

    @property
    def color(self) -> torch.Tensor:
        return self.wf.color if self.whole else self.color_all[:self.r]


class _Frame:
    """Rows [row0, row0 + bh) of the (h, w) frame (``kind`` "band":
    ``render_band`` without a mesh) or the whole camera (``kind``
    "camera": ``render_camera``'s radiance, bh = h) as a program of
    ``progs`` (``programs.render_programs``: kept, or run in place), the
    counterpart of ``_render_band_jit`` / ``_render_camera_jit``.  Its
    static inputs ``vec`` (the (5, 3) camera vector) and ``row0`` (f32)
    are copied in before each run, so every band and camera of one shape
    shares one capture, as in JAX, where they are traced.  A jittered band
    (``jittered``) samples the offsets in its static ``jitter`` ((bh, w,
    2)): with ``drawn`` the prologue draws them itself, as
    ``_render_band_jit`` does, under the key words that each run writes
    into the static ``key`` ((2,) int64, ``jitter_key(seed, ("band",
    row0))``); otherwise they are given to each run and copied in (a
    caller's ``jitter``).  Steps: a prologue (the draw, eye rays, the
    engine's tile order, the rays' ``load``), the bounce steps of
    ``_Rays`` (chunk by chunk when ``trace`` would cut the band), and an
    epilogue (``_band_image``) into the static ``out``."""

    def __init__(self, progs, data: SceneData, meta: SceneMeta, accel,
                 kind: str, h: int, w: int, bh: int, chunk: int, ssaa: int,
                 ssaa_mode: str, hdr: bool, jittered: bool, bfc: bool,
                 relaxed: bool, device, engine: str = "cluster",
                 drawn: bool = False):
        self.kind, self.h, self.w, self.bh = kind, h, w, bh
        self.ssaa, self.ssaa_mode, self.hdr = ssaa, ssaa_mode, hdr
        self.engine = engine
        self._init_trace(progs, data, meta, accel, chunk, bfc, relaxed, device)
        self.blocks, self.perm, self.inv = _tile_order(bh, w, device, engine)
        f32 = dict(dtype=torch.float32, device=device)
        self.vec = torch.zeros((5, 3), **f32)
        self.row0 = torch.zeros((), **f32)
        self.jitter = torch.zeros((bh, w, 2), **f32) if jittered else None
        self.key = (torch.zeros((2,), dtype=torch.int64, device=device)
                    if jittered and drawn else None)
        self.key_words = None if self.key is None else list(self.key)
        s = max(ssaa, 1)
        self.out = torch.zeros((bh // s, w // s, 3), device=device,
                               dtype=torch.float32 if hdr else torch.uint8)
        self.prologue = progs.step(f"{kind} prologue", self._prologue)
        self.epilogue = progs.step(f"{kind} epilogue", self._epilogue)

    @torch.no_grad()
    def __call__(self, vec, row0: int = 0, jitter=None,
                 seed: int = 0) -> torch.Tensor:
        """The band's image (the static ``out``: copy it before the next
        run) for camera vector ``vec`` and first row ``row0``, sampled at
        the offsets ``jitter`` (given) or at the draw of ``seed`` (drawn;
        OverflowError for a seed out of [0, 2**32), before any step)."""
        if self.key is not None:
            write_jitter_keys(self.key_words, seed, [("band", row0)])
        elif self.jitter is not None:
            self.jitter.copy_(jitter)
        self.vec.copy_(vec)
        self.row0.fill_(row0)
        self.prologue()
        self._trace()
        self.epilogue()
        return self.out

    def _init_trace(self, progs, data, meta, accel, chunk, bfc, relaxed,
                    device) -> None:
        self.rays = _Rays(progs, data, meta, accel, self.bh * self.w, chunk,
                          True, bfc, relaxed, "auto", device, self.engine)

    def _load(self, origin, dirs) -> None:
        self.rays.load(origin, dirs)

    def _trace(self) -> None:
        self.rays.run()

    def _color(self) -> torch.Tensor:
        return self.rays.color

    def _prologue(self) -> None:
        if self.kind == "camera":
            origin, dirs = eye_rays_from(self.vec, self.w, self.h)
        else:
            if self.key is not None:
                draw_jitter_into(self.key, self.jitter)
            origin, dirs = eye_rays_band(self.vec, self.w, self.h, self.row0,
                                         self.bh, jitter=self.jitter)
        self._load(origin, apply_tile_order(dirs, self.bh, self.w,
                                            self.blocks, self.perm))

    def _epilogue(self) -> None:
        self.out.copy_(_band_image(self._color(), self.bh, self.w,
                                   self.blocks, self.inv, self.ssaa,
                                   self.ssaa_mode, self.hdr))


class _Shard:
    """One shard of a mesh band (``_MeshFrame``): ``src`` (its slice of the
    band's tile-ordered rays, with their shared ``origin``) traced by
    ``rays`` (the ``_Rays`` of its device, shared by the shards there,
    which run one after another) into ``dst`` (its slice of this process's
    radiance).  Steps of ``progs`` (the programs of the shard's device):
    ``load`` copies the rays into ``rays``, ``store`` its radiance out.  A
    shard on another device than ``src``'s stages both through static
    buffers on its own device, copied between graphs."""

    def __init__(self, progs, rays: _Rays, origin, src, dst, name: str):
        self.rays, self.origin, self.src, self.dst = rays, origin, src, dst
        d = rays.wf.dirs.device
        self.staged = src.device != d
        self.in_origin, self.in_dirs, self.out = (
            [torch.zeros_like(x, device=d) for x in (origin, src, dst)]
            if self.staged else (origin, src, dst))
        self.load = progs.step(f"{name} load", self._load)
        self.store = progs.step(f"{name} store", self._store)

    def _load(self) -> None:
        self.rays.load(self.in_origin, self.in_dirs)

    def _store(self) -> None:
        self.out.copy_(self.rays.color)

    @torch.no_grad()
    def __call__(self) -> None:
        if self.staged:
            self.in_origin.copy_(self.origin)
            self.in_dirs.copy_(self.src)
        self.load()
        self.rays.run()
        self.store()
        if self.staged:
            self.dst.copy_(self.out)


class _MeshFrame(_Frame):
    """A band on a mesh (``render_band`` with ``mesh``) as a program, the
    counterpart of ``_render_band_jit``'s ``shard_map``.  The prologue (on
    the mesh's first device, ``device``) writes the band's tile-ordered
    rays into the static ``origin`` and ``dirs``; each of this process's
    shards (``band / mesh.size`` rays, cut into chunks as ``trace`` cuts
    them) then runs as a ``_Shard`` on its device, in the programs
    (``programs.render_programs``) of its device's copy of the scene
    (``parallel.mesh.replicate``), writing its
    slice of this process's radiance ``local``; with several processes the
    gather (``distributed.gather_rows``, over host copies on gloo) runs
    between graphs into the static ``color`` of the whole band; the
    epilogue reduces it into ``out``.  The image is the one-device band's
    bit for bit: the same rays, in whole blocks per shard, traced by the
    same bodies."""

    def __init__(self, progs, data, meta, accel, mesh, *args):
        self.mesh = mesh
        super().__init__(progs, data, meta, accel, *args)

    def _init_trace(self, progs, data, meta, accel, chunk, bfc, relaxed,
                    device) -> None:
        from raytracer_tpu_torch.parallel.mesh import replicate

        mesh = self.mesh
        r = self.bh * self.w
        per = r // mesh.size
        first = mesh.rank * len(mesh.devices)
        f32 = dict(dtype=torch.float32, device=device)
        self.origin = torch.zeros((3,), **f32)
        self.dirs = torch.zeros((r, 3), **f32)
        self.local = torch.zeros((per * len(mesh.devices), 3), **f32)
        self.color = (self.local if mesh.world == 1
                      else torch.zeros((r, 3), **f32))
        rays, self.shards = {}, []
        for i, (d, d_data, d_accel) in enumerate(zip(
                mesh.devices, replicate(mesh, data), replicate(mesh, accel))):
            d_progs = programs.render_programs(d_data, meta, d_accel, d)
            if d not in rays:
                rays[d] = _Rays(d_progs, d_data, meta, d_accel, per, chunk,
                                True, bfc, relaxed, "auto", d, self.engine)
            k = first + i
            self.shards.append(_Shard(
                d_progs, rays[d], self.origin,
                self.dirs[k * per:(k + 1) * per],
                self.local[i * per:(i + 1) * per], f"shard {k}"))

    def _load(self, origin, dirs) -> None:
        self.origin.copy_(origin)
        self.dirs.copy_(dirs)

    def _trace(self) -> None:
        for shard in self.shards:
            shard()
        if self.mesh.world > 1:
            # a host step between graphs (gloo gathers host copies)
            from raytracer_tpu_torch.parallel import distributed

            self.color.copy_(distributed.gather_rows(self.local, self.mesh))

    def _color(self) -> torch.Tensor:
        return self.color


def _frame(progs, data, meta, accel, kind: str, h: int, w: int, bh: int,
           chunk: int, ssaa: int, ssaa_mode: str, hdr: bool, jittered: bool,
           bfc: bool, relaxed: bool, engine: str, mesh=None,
           drawn: bool = False) -> _Frame:
    """The frame program of this engine and shape from ``progs``
    (``programs.render_programs``: the scene's kept one, or a new one):
    ``_Frame``, over ``mesh`` when given ``_MeshFrame`` (a band); a
    jittered band's offsets ``drawn`` by its prologue or given to it are
    two programs."""
    jitter = ("drawn" if drawn else "given") if jittered else None
    key = ("frame", kind, h, w, bh, chunk, ssaa, ssaa_mode, hdr, jitter,
           bfc, relaxed, engine, mesh)
    args = (kind, h, w, bh, chunk, ssaa, ssaa_mode, hdr, jittered, bfc,
            relaxed, data.device, engine, drawn)
    if mesh is None:
        return progs.program(key, lambda: _Frame(progs, data, meta, accel,
                                                 *args))
    return progs.program(key, lambda: _MeshFrame(progs, data, meta, accel,
                                                 mesh, *args))


def render_camera_streamed(data: SceneData, meta: SceneMeta, cam: Camera,
                           accel, chunk: int = 1 << 22,
                           bfc: bool = False, ssaa: int = 1,
                           ssaa_mode: str = "parity", hdr: bool = False,
                           seed: int = 0, relaxed: bool = False,
                           device="cuda", jitter=None, engine: str = "auto",
                           mesh=None):
    """Render one camera to its final-resolution (H, W, 3) uint8 image (f32
    radiance when ``hdr``) on ``device`` through ``engine``
    (``resolve_engine``) by streaming row bands of the SSAA-scaled frame,
    each one run of a band program (``_Frame``, ``render_band``'s) of the
    render's programs (``programs.render_programs``).  Bands are
    ``max(lcm, (chunk // W*ssaa) // lcm * lcm)`` rows, lcm = lcm(16,
    ssaa), the last one shorter, as in the JAX package: a band holds whole
    SSAA pixels, and the jitter mode (ssaa > 1) draws each band's offsets
    keyed on (seed, its first row) as the JAX package does
    (``ops.camera.draw_jitter``; the seed must lie in [0, 2**32)).
    ``jitter``: optional callable ``(key, shape) -> array`` that supplies
    those draws instead (key ``("band", row0)``, shape (rows, W*ssaa,
    2)).

    ``mesh`` (``parallel.mesh.Mesh`` of more than one shard, its first
    device ``device``): each band's rays are split over it.  The lcm then
    also takes 8 rows (the cluster engine's block; 1 row otherwise) per
    shard, so every shard holds whole blocks, as in the JAX package, whose
    band heights (and so jitter sample sets) this keeps; a short last band
    is padded with virtual rows below the frame (the eye rays extrapolate
    the image plane), rendered and cropped.  A band on the mesh runs as
    one program (``_MeshFrame``) as a band on one device does
    (``_Frame``), on every engine; without ``jitter`` a jittered band's
    program draws its offsets itself, on every device (on a mesh, on its
    first device: every process draws the whole band), and a given
    ``jitter``'s offsets are copied in.

    Spans (``tracing``, while a profiler records): ``pipeline.upload``
    (the camera vector's upload and the programs' lookup),
    ``pipeline.band`` (each band, its first row in ``what``),
    ``pipeline.assemble`` (a band's copy out of its program; the bands'
    ``cat`` and crop)."""
    dev = _render_device(data, accel, device)
    engine = resolve_engine(engine, accel, meta)
    chunk = _cap_chunk_for_big_scenes(chunk, accel)
    hs, ws = cam.height * ssaa, cam.width * ssaa
    lcm = 16 * ssaa // math.gcd(16, ssaa)
    if mesh is not None and mesh.size > 1:
        if mesh.devices[0] != dev:
            raise ValueError(f"mesh on {mesh.devices[0]}, render on {dev}")
        shard_rows = _tile_block_shape()[0] if engine == "cluster" else 1
        lcm = math.lcm(lcm, shard_rows * mesh.size)
    else:
        mesh = None
    band_h = max(lcm, (chunk // ws) // lcm * lcm)
    # The lcm alignment can make a band larger than the chunk (ws * lcm >
    # chunk).  Such a band is traced in chunk-sized wavefronts of whole
    # tiles, as render_camera traces a frame, so ray state stays within
    # the (capped) chunk.  The tiles are the same; with the activity
    # compaction on, each wavefront compacts only its own rays, which can
    # change only which of two exactly equally near primitives wins (the
    # exact-t tie class).
    jittered = ssaa_mode == "jitter" and ssaa > 1
    with tracing.span("pipeline.upload"):
        vec = torch.from_numpy(camera_vectors(cam)).to(dev)
        progs = programs.render_programs(data, meta, accel, dev)
    drawn = jittered and jitter is None
    bands = []
    for row0 in range(0, hs, band_h):
        bh = min(band_h, hs - row0)
        if mesh is not None:
            bh = -(-bh // lcm) * lcm          # virtual rows below the frame
        with tracing.span("pipeline.band", row0):
            offsets = None
            if jittered and not drawn:
                offsets = draw_jitter(jitter, seed, ("band", row0),
                                      (bh, ws, 2), dev)
            with nan_site(f"band of rows {row0}-{row0 + bh - 1}"):
                band = _frame(progs, data, meta, accel, "band", hs, ws, bh,
                              chunk, ssaa, ssaa_mode, hdr, jittered, bfc,
                              relaxed, engine, mesh, drawn=drawn)(
                                  vec, row0, offsets, seed)
        with tracing.span("pipeline.assemble"):
            # a program's band is its static output: copied out
            bands.append(band.clone())
    with tracing.span("pipeline.assemble"):
        out = torch.cat(bands)
        return out[:cam.height] if out.shape[0] != cam.height else out
