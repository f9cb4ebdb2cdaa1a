"""Warm render server: ``python -m raytracer_tpu_torch.serve [options]``
(port of ``raytracer_tpu/serve.py``).

A resident process keeps scenes and their accelerators on the card (and
the CUDA kernel library loaded) across requests, so a preview loop or a
parameter sweep pays the load, the BVH and cluster builds and the kernel
build once instead of once per invocation.

Protocol: JSON lines.  Requests arrive one per line on stdin (or a TCP
socket on 127.0.0.1 with ``--port``; ``--port 0`` binds a free port and
prints it), responses leave one per line on stdout (or the socket).
Request fields, with their defaults:

    {"scene": "path/to/scene.xml",        # required
     "out_dir": ".",                      # where images are written
     "ssaa": 1, "ssaa_mode": "parity",    # parity|mean|jitter|adaptive
     "engine": "auto", "bfc": false,      # auto|brute|bvh|cluster
     "chunk": 4194304, "seed": 0,
     "adaptive_frac": 0.125, "adaptive_extra": null, "adaptive_rounds": 1,
     "format": "ppm",                     # ppm | png | exr
     "tone": "none",                      # none|gamma|reinhard|aces
     "camera": null,                      # index, or null = every camera
     "relaxed_parity": false,
     "id": "anything"}                    # echoed back

Commands: ``{"cmd": "ping"}`` -> ``{"ok": true, "pong": <time>}``;
``{"cmd": "stats"}`` -> ``{"ok": true, "scenes_cached": n, "renders":
n}``; ``{"cmd": "shutdown"}`` ends the loop.  Responses: ``{"ok": true,
"id": ..., "images": [...], "render_s": ..., "mrays_per_s": ...}`` (and
``"adaptive"`` in adaptive mode) or ``{"ok": false, "id": ...,
"error": "Type: message"}``: a request's error is reported, never
raised.

The scene cache is an LRU keyed on (realpath, mtime, engine): editing a
scene file invalidates its entry.  It holds the scene and its engine's
accelerator on the server's device: the clusters for cluster and auto,
the ``DeviceBVH`` for bvh, nothing for brute; evicting a scene drops its
captured render programs (``models.programs``), which replay on the card
for every warm request, on every engine.  Renders are split over
every card of the process by default (``--mesh auto``), bit for bit the
single-device image.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import OrderedDict

from raytracer_tpu_torch.backend import resolve_device
from raytracer_tpu_torch.models import programs
from raytracer_tpu_torch.parallel.mesh import mesh_from_arg


class RenderServer:
    """The request handler with its scene cache, apart from the I/O loop:
    ``RenderServer(device="cpu").handle({"scene": ...})``."""

    def __init__(self, max_scenes: int = 8, mesh: str = "auto",
                 device="cuda"):
        self.max_scenes = max_scenes
        self.device = resolve_device(device)
        self.mesh = mesh_from_arg(mesh, self.device)
        if self.mesh is not None:
            self.device = self.mesh.devices[0]
        self._scenes = OrderedDict()   # key -> (data, meta, accel), LRU first
        self.renders = 0

    def _load(self, scene_path: str, engine: str):
        """(data, meta, accel) of the scene for ``engine``, from the cache
        or loaded and built on the server's device."""
        from raytracer_tpu_torch.models.scene import load_scene
        from raytracer_tpu_torch.render import engine_accel

        path = os.path.realpath(scene_path)
        key = (path, os.stat(path).st_mtime, engine)
        if key in self._scenes:
            self._scenes.move_to_end(key)
            return self._scenes[key]
        data, meta = load_scene(path, device=self.device)
        accel = engine_accel(engine, None, data, meta, self.device)
        self._scenes[key] = (data, meta, accel)
        while len(self._scenes) > self.max_scenes:
            # the scene's captured programs go with it
            programs.drop(self._scenes.popitem(last=False)[1][0])
        return data, meta, accel

    def handle(self, req: dict) -> dict:
        cmd = req.get("cmd")
        if cmd == "ping":
            return {"ok": True, "pong": time.time()}
        if cmd == "stats":
            return {"ok": True, "scenes_cached": len(self._scenes),
                    "renders": self.renders}
        if cmd == "shutdown":
            return {"ok": True, "shutdown": True}
        try:
            return self._render(req)
        except Exception as e:  # noqa: BLE001 - a server reports, not dies
            return {"ok": False, "id": req.get("id"),
                    "error": f"{type(e).__name__}: {e}"}

    def _render(self, req: dict) -> dict:
        from raytracer_tpu_torch.pipeline import render_one_camera, write_image

        engine = req.get("engine", "auto")
        fmt = req.get("format", "ppm")
        out_dir = req.get("out_dir", ".")
        ssaa = int(req.get("ssaa", 1))
        cam_idx = req.get("camera")
        os.makedirs(out_dir, exist_ok=True)

        data, meta, accel = self._load(req["scene"], engine)
        cams = meta.cameras if cam_idx is None else [meta.cameras[cam_idx]]
        images = []
        rays = 0
        adaptive_stats = None
        t0 = time.perf_counter()
        for cam in cams:
            img, adaptive_stats = render_one_camera(
                data, meta, cam, accel, engine=engine, ssaa=ssaa,
                ssaa_mode=req.get("ssaa_mode", "parity"),
                bfc=bool(req.get("bfc", False)),
                chunk=int(req.get("chunk", 1 << 22)),
                tone=req.get("tone", "none"), hdr=fmt == "exr",
                seed=int(req.get("seed", 0)),
                adaptive_frac=float(req.get("adaptive_frac", 0.125)),
                adaptive_extra=req.get("adaptive_extra"),
                adaptive_rounds=int(req.get("adaptive_rounds", 1)),
                relaxed=bool(req.get("relaxed_parity", False)),
                device=self.device, mesh=self.mesh)
            images.append(write_image(out_dir, cam.image_name, img, fmt))
            rcam = cam.scaled(ssaa) if ssaa > 1 else cam
            rays += rcam.width * rcam.height
        dt = time.perf_counter() - t0
        self.renders += len(cams)
        resp = {"ok": True, "id": req.get("id"), "images": images,
                "render_s": round(dt, 4),
                "mrays_per_s": round(rays / dt / 1e6, 3)}
        if adaptive_stats is not None:
            resp["adaptive"] = adaptive_stats
        return resp


def _serve_stream(server: RenderServer, rfile, wfile) -> bool:
    """Answer one JSON-lines stream; True when shutdown was asked."""
    for line in rfile:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
        except json.JSONDecodeError as e:
            resp = {"ok": False, "error": f"bad json: {e}"}
        else:
            resp = (server.handle(req) if isinstance(req, dict) else
                    {"ok": False, "error": "a request is a JSON object"})
        wfile.write(json.dumps(resp) + "\n")
        wfile.flush()
        if resp.get("shutdown"):
            return True
    return False


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="raytracer_tpu_torch render server (JSON lines)")
    ap.add_argument("--port", type=int, default=None,
                    help="listen on TCP 127.0.0.1:PORT instead of stdin "
                         "(0: a free port, printed in the ready line)")
    ap.add_argument("--max-scenes", type=int, default=8,
                    help="scene/accel LRU cache capacity")
    ap.add_argument("--mesh", default="auto", metavar="auto|N",
                    help="device mesh: auto (default) splits every render "
                         "over the process's cards; N shards (on the CPU, "
                         "logical ones); 1 = one device")
    ap.add_argument("--warmup", metavar="SCENE", default=None,
                    help="render this scene once at start-up (into a "
                         "temporary directory) so that the kernels are built "
                         "and loaded before the first request")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default; the CUDA kernels) or cpu (the plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)

    server = RenderServer(max_scenes=args.max_scenes, mesh=args.mesh,
                          device=args.device)
    if args.warmup:
        import tempfile

        with tempfile.TemporaryDirectory() as td:
            r = server.handle({"scene": args.warmup, "out_dir": td})
        print(json.dumps({"warmup": r.get("ok"), "render_s": r.get("render_s"),
                          "error": r.get("error")}),
              file=sys.stderr, flush=True)

    if args.port is None:
        print(json.dumps({"ready": True}), flush=True)
        _serve_stream(server, sys.stdin, sys.stdout)
        return

    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind(("127.0.0.1", args.port))
        sock.listen(4)
        print(json.dumps({"ready": True, "port": sock.getsockname()[1]}),
              flush=True)
        stop = False
        while not stop:
            conn, _ = sock.accept()
            try:
                with conn, conn.makefile("r", encoding="utf-8") as rfile, \
                        conn.makefile("w", encoding="utf-8") as wfile:
                    stop = _serve_stream(server, rfile, wfile)
            except OSError as e:
                # a client that drops mid-stream (a broken pipe, a reset)
                # must not end the server and its warm state
                print(json.dumps({"client_error": str(e)}),
                      file=sys.stderr, flush=True)

if __name__ == "__main__":
    main()
