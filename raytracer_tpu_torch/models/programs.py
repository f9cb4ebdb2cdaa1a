"""Compiled programs: each engine's wavefront, its frames, the adaptive
frame and the training step as CUDA graphs, the port's
counterparts of the JAX package's jitted programs ``_render_rays_jit``,
``_render_camera_jit`` and ``_render_band_jit``
(``raytracer_tpu/models/whitted.py:306-398``), ``_adaptive_jit``
(``raytracer_tpu/ops/adaptive.py:82``), the jitted train step
(``raytracer_tpu/parallel/train.py:118``) and the jitted ``shard_map``
render (``raytracer_tpu/parallel/render.py:29-44``; the band's
``shard_map`` at ``raytracer_tpu/models/whitted.py:373-390``).

XLA runs each of those programs as one dispatch, with the bounce loop's
control on the device.  Here a program is a set of *steps*: each step is
a function of static tensors only (inputs are copied into fixed buffers
before a run, results are written into fixed buffers in place), so that
one CUDA graph of it serves every later run of the same shape.  The
bodies live in ``models.whitted`` (``_Wavefront``, ``_Rays``, ``_Frame``),
``ops.adaptive`` (``_Adaptive``) and ``parallel.train``
(``_TrainProgram``), the mesh band in ``models.whitted``
(``_MeshFrame``); this module holds what they share.  Every render runs
these program objects, one route run two ways: kept and captured on a
CUDA device, made anew and run in place elsewhere.

- ``Step``: one body.  Its first run is eager: it computes the result and
  warms every kernel instance the body launches (the kernel library's
  build, the SM count, the dynamic shared memory attribute are all set up
  once, outside any capture).  Right after it the body is captured, which
  runs nothing, and every later run replays the graph.  The launch counts
  of ``ops.kernels`` count in Python, which runs only at capture: a step
  records what its capture added, takes it back, and adds it again on
  every replay, so ``kernels.launches`` stays the number of kernels the
  card ran.
- ``scene_programs(data, meta, accel, device)``: the programs of one
  scene, keyed on the identity and version counters of its tensors (a
  graph bakes in their pointers; an in-place edit makes a new entry), an
  LRU of ``MAX_SCENES`` scenes; ``drop(data)`` forgets a scene's programs
  (the server's LRU does so when it evicts the scene).  All the programs
  of one scene share one graph memory pool: they run one after another.
  A scene's programs belong to one device: their steps run, are captured
  and replay with it as the current device (a mesh of several cards in
  one process has a scene, so programs and a pool, per card).
- ``EAGER``: the programs of a render that captures nothing.  Each
  program is made anew and kept nowhere, each step is its body, run on
  every call; so an eager render keeps nothing once it returns.
- ``render_programs(data, meta, accel, device)``: the one place where a
  render chooses between them: the scene's kept programs where
  ``enabled`` (a CUDA device, outside ``eager()``), else ``EAGER``.
- ``replica(obj, device)``: one copy of a scene object per (object,
  device), for the shards of a mesh (``parallel.mesh.replicate``), kept
  while the object's tensors are not edited in place, so that another
  device's programs, keyed on the copy, replay frame after frame;
  ``drop`` and ``clear`` forget the copies with the programs.
- ``eager()``: inside the block nothing is captured or replayed, the
  counterpart of ``jax.disable_jit()``.  The checks that record kernel
  calls and the tests run the same bodies this way; ``--debug-nans``
  (``whitted.debug_nans``) does too.

- ``read_flags`` / ``run_while``: the host reads a program's flag
  tensors between its steps (the wavefront's early exit and compaction
  gate between bounces, the BVH walk's loop test between blocks of
  iterations), as XLA's while_loop reads its predicate; ``stats`` counts
  the reads.

Spans (``tracing``): ``program.step`` around a replay and
``program.flags`` around a flag read, while a profiler records;
``program.first`` (a step's first, eager run), ``program.capture`` and
``program.make`` (``Programs.program``'s construction of a program)
always, as set-up.  Each names its step or program in ``what``.  The
eager programs record no ``program.*`` span but ``program.flags``.

A capture that fails raises, naming the step; nothing falls back to
eager.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import weakref
from collections import OrderedDict

import torch

from raytracer_tpu_torch import tracing
from raytracer_tpu_torch.ops import kernels

# scenes whose programs are kept (least recently used first out)
MAX_SCENES = 8

_eager = [0]
_scenes: "OrderedDict[tuple, Programs]" = OrderedDict()
# (id of a source object, device) -> (the source, its versions, its copy),
# for at most 2 * MAX_SCENES sources (a scene and its accelerator each)
_replicas: "OrderedDict[tuple, tuple]" = OrderedDict()

# captures made in this process and the host's reads of a program's flags
# (``read_flags``); the captures' seconds are their ``program.capture``
# spans' (``tracing.seconds``)
stats = {"captures": 0, "flag_reads": 0}


@contextlib.contextmanager
def eager():
    """Inside the block every render runs its bodies eagerly: no capture,
    no replay (``jax.disable_jit()``'s counterpart)."""
    _eager[0] += 1
    try:
        yield
    finally:
        _eager[0] -= 1


class CudaGraph:
    """One ``torch.cuda.CUDAGraph`` captured into the memory pool ``pool``
    (``torch.cuda.graph`` captures on a side stream).  The garbage
    collector is off while it captures: ``torch.cuda.graph`` collects
    first, and a collection during the capture could destroy another
    program's graphs and free its pool (a dropped program is a reference
    cycle), calls that invalidate the capture."""

    def __init__(self, pool):
        self.graph = torch.cuda.CUDAGraph()
        self.pool = pool

    def capture(self, body) -> None:
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, pool=self.pool):
                body()
        finally:
            if collecting:
                gc.enable()

    def replay(self) -> None:
        self.graph.replay()


def graph_class(device):
    """The graph type that captures on ``device``: ``CudaGraph`` on a CUDA
    device, None (run eagerly) on the CPU and inside ``eager()``."""
    if _eager[0] or torch.device(device).type != "cuda":
        return None
    return CudaGraph


def enabled(device) -> bool:
    """True when renders on ``device`` run as captured programs."""
    return graph_class(device) is not None


def _on(device):
    """Inside the block the CUDA device ``device`` is the current one (a
    capture records and a replay launches on its current stream); nothing
    for None or the CPU."""
    if device is None or torch.device(device).type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def read_flags(flags: torch.Tensor) -> list:
    """The values of the device tensor ``flags`` on the host (a sync),
    counted in ``stats``: how a program decides between its steps, as
    XLA's while_loop reads its predicate on the host once an iteration."""
    stats["flag_reads"] += 1
    with tracing.span("program.flags"):
        return flags.tolist()


def run_while(flag: torch.Tensor, step) -> int:
    """Run ``step`` while the one-element flag ``flag``, which the step
    rewrites, reads true (read before every run); returns the runs."""
    n = 0
    while read_flags(flag)[0]:
        step()
        n += 1
    return n


class Step:
    """``body()`` as a program step: eager on its first run, then captured
    into a graph from ``new_graph()`` and replayed (see the module
    docstring), each with ``device`` current."""

    def __init__(self, name: str, body, new_graph, device=None):
        self.name = name
        self.body = body
        self.new_graph = new_graph
        self.device = device
        self.graph = None
        self.launches = {}

    def __call__(self) -> None:
        with _on(self.device):
            if self.graph is not None:
                with tracing.span("program.step", self.name):
                    self.graph.replay()
                for k, n in self.launches.items():
                    kernels.launches[k] += n
                return
            with tracing.setup_span("program.first", self.name):
                self.body()
            self._capture()

    def _capture(self) -> None:
        before = dict(kernels.launches)
        graph = self.new_graph()
        try:
            with tracing.setup_span("program.capture", self.name):
                graph.capture(self.body)
        except Exception as e:
            raise RuntimeError(f"capture of the step {self.name!r} failed: "
                               f"{type(e).__name__}: {e}") from e
        finally:
            added = {k: kernels.launches[k] - n for k, n in before.items()}
            kernels.launches.update(before)      # the capture ran nothing
        stats["captures"] += 1
        self.launches = {k: n for k, n in added.items() if n}
        self.graph = graph


class Programs(dict):
    """One scene's programs by key, sharing one graph memory pool, on
    ``device``.  Holds the scene's objects, so that the ids it is keyed on
    stay theirs."""

    def __init__(self, refs: tuple, versions: tuple, graph_type, device=None):
        super().__init__()
        self.refs = refs
        self.versions = versions
        self.graph_type = graph_type
        self.device = device
        self.pool = None

    def _new_graph(self):
        if self.pool is None and self.graph_type is CudaGraph:
            self.pool = torch.cuda.graph_pool_handle()
        return self.graph_type(self.pool)

    def step(self, name: str, body) -> Step:
        """A ``Step`` of ``body`` captured into this scene's pool."""
        return Step(name, body, self._new_graph, self.device)

    def program(self, key, make):
        """The program under ``key``, made by ``make()`` on first use."""
        prog = self.get(key)
        if prog is None:
            with tracing.setup_span("program.make",
                                    " ".join(map(str, key[:2]))):
                prog = self[key] = make()
        return prog


class Eager:
    """The programs of a render that captures nothing (``EAGER``): the
    counterpart of ``Programs`` whose steps run their bodies in place and
    whose programs are kept nowhere."""

    @staticmethod
    def step(name: str, body):
        """``body`` (a bound method, or a ``functools.partial`` of one),
        run on every call.  It holds the body's object weakly: a program
        keeps its steps, and steps that held the program would make a
        reference cycle, which only the garbage collector frees."""
        args = ()
        if isinstance(body, functools.partial):
            body, args = body.func, body.args
        method = weakref.WeakMethod(body)
        return lambda: method()(*args)

    @staticmethod
    def program(key, make):
        """A new ``make()``, kept nowhere."""
        return make()


EAGER = Eager()


def render_programs(data, meta, accel, device):
    """The programs that a render of the scene (``data``, ``meta``,
    ``accel``) on ``device`` runs: the scene's kept programs
    (``scene_programs``) where ``enabled``, else ``EAGER``."""
    if enabled(device):
        return scene_programs(data, meta, accel, device)
    return EAGER


def _tensors(obj, skip=()) -> list:
    """``obj`` itself if it is a tensor, else the tensor fields of the
    dataclass ``obj`` but those named in ``skip``."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    return [getattr(obj, f.name) for f in dataclasses.fields(obj)
            if f.name not in skip
            and isinstance(getattr(obj, f.name), torch.Tensor)]


def _versions(*objs, skip=()) -> tuple:
    """The version counters of the tensors of ``objs`` (tensors or
    dataclasses; None is skipped) but the fields named in ``skip``: they
    change with any in-place edit."""
    return tuple(t._version for o in objs if o is not None
                 for t in _tensors(o, skip))


def scene_programs(data, meta, accel, device) -> Programs:
    """The programs of the scene (``data``, ``meta``, ``accel``) on
    ``device`` (where ``enabled``), made empty on first use."""
    key = (id(data), id(meta), id(accel))
    versions = _versions(data, accel)
    progs = _scenes.get(key)
    if progs is None or progs.versions != versions:
        stale = progs is not None
        progs = _scenes[key] = Programs((data, meta, accel), versions,
                                        graph_class(device),
                                        torch.device(device))
        while len(_scenes) > MAX_SCENES:
            _scenes.popitem(last=False)
            stale = True
        if stale:
            gc.collect()            # see clear()
    _scenes.move_to_end(key)
    return progs


def cached(data) -> int:
    """The number of programs kept for scenes of ``data``."""
    return sum(len(p) for p in _scenes.values() if p.refs[0] is data)


def replica(obj, device):
    """``obj`` (a tensor or a dataclass of tensors with ``to``) on
    ``device``: ``obj`` itself where its tensors lie there, else its copy
    there, made on first use and kept while ``obj``'s tensors keep their
    version counters (an in-place edit makes a new copy)."""
    device = torch.device(device)
    if all(t.device == device for t in _tensors(obj)):
        return obj
    key = (id(obj), device)
    versions = _versions(obj)
    kept = _replicas.get(key)
    if kept is None or kept[1] != versions:
        kept = _replicas[key] = (obj, versions, obj.to(device))
    _replicas.move_to_end(key)
    while len({i for i, _ in _replicas}) > 2 * MAX_SCENES:
        _replicas.popitem(last=False)
    return kept[2]


def drop(data) -> None:
    """Forget the programs of every scene of ``data`` and of its copies on
    other devices (and so their graphs, their pool and their hold on the
    scene's tensors), and those copies and the copies of its scenes'
    accelerators."""
    sources = {id(data)} | {id(p.refs[2]) for p in _scenes.values()
                            if p.refs[0] is data and p.refs[2] is not None}
    copies = {id(data)} | {id(c) for (i, _), (_, _, c) in _replicas.items()
                           if i == id(data)}
    for key in [k for k, p in _scenes.items() if id(p.refs[0]) in copies]:
        del _scenes[key]
    for key in [k for k in _replicas if k[0] in sources]:
        del _replicas[key]
    gc.collect()                    # see clear()


def clear() -> None:
    """Forget every scene's programs and every replica."""
    _scenes.clear()
    _replicas.clear()
    # a program's steps call its bound methods, a reference cycle: collect
    # it now, so that its graphs, pool and buffers go with it
    gc.collect()
