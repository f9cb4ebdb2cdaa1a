"""Frame traffic: a closed loop with one client.  Frames run back to back
through ``raytracer_tpu_torch.pipeline.render_one_camera`` (the mix's
SSAA factor, mode, chunk and engine); each uint8 image comes back to the
host and none is written.  Frame k's camera is the configuration's camera
turned about the vertical by ``sweep_deg * sin(2 pi k / sweep_frames)``,
the same path for every seed, so consecutive frames differ and the
resolution never changes.

Set-up: the scene from the seed, written as XML and loaded through the
port's ``load_scene``, the accelerator, ``warmup_frames`` frames (the
first eager, then the captures).  Window: frames until ``--seconds``
have passed; ``mrays_per_s`` is every primary ray (SSAA samples counted)
of the window's frames over its seconds.  Traced: ``trace_frames``
frames from ``trace_after`` of the window on run under the profiler, each
in a ``bench.frame`` span, and after the window one eager frame records
its kernel calls' roofline bound.  Then the program is freed and
``check_frames`` of the window's frames, drawn from the seed, are
compared on ``check_tiles`` tiles each with the plain reference.
"""

from __future__ import annotations

import math
import os
import time

import numpy as np

from benchmark import harness, imagecheck, sceneio


def camera_at(cam: dict, k: int, traffic: dict) -> dict:
    """Frame ``k``'s camera: ``cam`` with its gaze turned about +y."""
    a = math.radians(traffic["sweep_deg"]) * math.sin(
        2 * math.pi * k / traffic["sweep_frames"])
    gx, gy, gz = cam["gaze"]
    return dict(cam, gaze=[gx * math.cos(a) + gz * math.sin(a), gy,
                           -gx * math.sin(a) + gz * math.cos(a)])


def port_camera(c: dict):
    from raytracer_tpu_torch.models.scene import Camera

    return Camera(position=tuple(c["position"]), gaze=tuple(c["gaze"]),
                  up=tuple(c["up"]), near_plane=tuple(c["near_plane"]),
                  near_distance=c["near_distance"], width=c["width"],
                  height=c["height"], image_name=c["image_name"])


def run(ctx) -> None:
    from raytracer_tpu_torch.models import whitted
    from raytracer_tpu_torch.models.scene import load_scene
    from raytracer_tpu_torch.pipeline import render_one_camera
    from raytracer_tpu_torch.render import engine_accel

    tr, dev = ctx.traffic, ctx.device
    parsed = sceneio.generate(ctx.bench, ctx.config, ctx.seed)
    xml = os.path.join(ctx.work_dir, "scene.xml")
    sceneio.write_xml(parsed, xml)
    data, meta = load_scene(xml, device=dev)
    accel = engine_accel(tr["engine"], None, data, meta, dev)
    cam0 = parsed["cameras"][tr["camera"]]
    ssaa = tr["ssaa"]
    rays = cam0["width"] * cam0["height"] * ssaa * ssaa

    def frame(k: int) -> np.ndarray:
        img, _ = render_one_camera(
            data, meta, port_camera(camera_at(cam0, k, tr)), accel,
            ssaa=ssaa, ssaa_mode=tr["ssaa_mode"], chunk=tr["chunk"],
            engine=tr["engine"], device=dev)
        return img

    for k in range(tr["warmup_frames"]):
        frame(k)
    if ctx.trace_on:
        harness.warm_profiler(dev)
    ctx.setup_done()

    images, prof, first = [], None, 0
    t0 = time.perf_counter()
    # a traced run goes on until its stretch is whole
    while (time.perf_counter() - t0 < ctx.seconds
           or (prof is not None and ctx.trace is None)):
        k = len(images)
        if (ctx.trace_on and prof is None
                and time.perf_counter() - t0 >= tr["trace_after"] * ctx.seconds):
            prof, first = harness.Profiled(
                harness.port_kernel_names(ctx.bench.root)).__enter__(), k
        with harness.span("frame"):
            images.append(frame(k))
        if (prof is not None and ctx.trace is None
                and k + 1 - first >= tr["trace_frames"]):
            prof.__exit__(None, None, None)
            ctx.trace = prof.trace({})
    window = time.perf_counter() - t0
    ctx.attempted = len(images)
    ctx.e2e["mrays_per_s"] = len(images) * rays / window / 1e6
    ctx.read_peak()
    if prof is not None and ctx.trace is None:
        prof.__exit__(None, None, None)
        ctx.trace = prof.trace({})
    if ctx.trace_on and dev != "cpu":
        from benchmark import roofline

        with whitted.eager(), roofline.Recorder(roofline.peak_ops()) as rec:
            frame(0)
        ctx.trace.counters["roofline_bound_ms"] = rec.bound_s * 1e3
        ctx.trace.counters["roofline_calls"] = rec.calls
    del data, accel, meta
    harness.free_program()
    t_ref = time.perf_counter()
    check_frames(ctx, parsed, cam0, images)
    harness.log(f"reference check: {time.perf_counter() - t_ref:.3f} s")


def check_frames(ctx, parsed: dict, cam0: dict, images: list) -> None:
    """``check_frames`` of ``images`` (frame k's at k) against the plain
    reference on ``check_tiles`` tiles each, both drawn from the seed."""
    from benchmark.reference import whitted as ref

    tr = ctx.traffic
    rng = np.random.default_rng(abs(ctx.seed))
    scene = ref.Scene(parsed, ctx.device)
    tally = imagecheck.Tally()
    picks = rng.choice(len(images), size=min(tr["check_frames"], len(images)),
                       replace=False)
    for k in sorted(int(i) for i in picks):
        cam = camera_at(cam0, k, tr)
        tiles = imagecheck.sample_tiles(rng, cam["height"], cam["width"],
                                        tr["check_tiles"])
        got = ref.tiles_image(scene, cam, tr["ssaa"], tiles,
                              imagecheck.TILE).cpu().numpy()
        tally.add(got, images[k], tiles)
    tally.report(ctx)
