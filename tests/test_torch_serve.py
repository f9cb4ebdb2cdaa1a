"""The port's render server (``raytracer_tpu_torch/serve.py``) on the CPU:
the cases of the JAX package's tests/test_serve.py on the in-repo entry
scene and XML variants written here (a second camera, a touched mtime, a
second scene for the LRU), the stdin and TCP protocols in subprocesses,
the server on a 4-shard CPU mesh, and the port's server against the JAX
package's ``RenderServer(mesh="1")`` at the image bars."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from torch_port_util import ENTRY_XML, bad_pixels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def server():
    from raytracer_tpu_torch.serve import RenderServer

    return RenderServer(max_scenes=2, mesh="1", device="cpu")


@pytest.fixture
def scenes(tmp_path):
    """Variants of the entry scene: ``two_cams`` adds a 32x32 camera
    looking down, ``other`` is the scene with another albedo."""
    with open(ENTRY_XML) as f:
        text = f.read()
    cam2 = """        <Camera id="2">
            <Position>0 3 -4</Position>
            <Gaze>0 -1 0</Gaze>
            <Up>0 0 -1</Up>
            <NearPlane>-1 1 -1 1</NearPlane>
            <NearDistance>1</NearDistance>
            <ImageResolution>32 32</ImageResolution>
            <ImageName>top.ppm</ImageName>
        </Camera>
    </Cameras>"""
    out = {}
    for name, body in (("two_cams", text.replace("    </Cameras>", cam2, 1)),
                       ("other", text.replace("0.8 0.4 0.2", "0.2 0.4 0.8"))):
        path = tmp_path / f"{name}.xml"
        path.write_text(body)
        out[name] = str(path)
    return out


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_ping_and_stats(server):
    r = server.handle({"cmd": "ping"})
    assert r["ok"] and "pong" in r
    st = server.handle({"cmd": "stats"})
    assert st["ok"] and "scenes_cached" in st and "renders" in st


def test_render_matches_cli_path(server, tmp_path):
    """A request renders the CLI's image bit for bit (the server's ssaa
    defaults to 1, the CLI's to 2)."""
    from raytracer_tpu_torch.render import main
    from raytracer_tpu_torch.utils.ppm import read_ppm

    r = server.handle({"scene": ENTRY_XML, "out_dir": str(tmp_path / "srv"),
                       "id": "req-1"})
    assert r["ok"], r
    assert r["id"] == "req-1" and len(r["images"]) == 1
    assert r["render_s"] > 0 and r["mrays_per_s"] > 0
    main([ENTRY_XML, "--ssaa", "1", "--device", "cpu", "--out-dir",
          str(tmp_path / "cli")])
    np.testing.assert_array_equal(read_ppm(r["images"][0]),
                                  read_ppm(str(tmp_path / "cli" / "entry_scene.ppm")))


def test_scene_cache_reuse_and_lru(tmp_path, scenes):
    """Keyed on (path, mtime, engine): a repeat is a hit, another engine
    or a touched file a new entry, and past 2 entries the least recently
    used goes."""
    from raytracer_tpu_torch.serve import RenderServer

    srv = RenderServer(max_scenes=2, mesh="1", device="cpu")
    cached = lambda: srv.handle({"cmd": "stats"})["scenes_cached"]  # noqa: E731
    req = {"scene": ENTRY_XML, "out_dir": str(tmp_path)}
    assert srv.handle(req)["ok"] and cached() == 1
    first = next(iter(srv._scenes.values()))
    assert srv.handle(req)["ok"] and cached() == 1
    assert next(iter(srv._scenes.values()))[0] is first[0]
    assert srv.handle(dict(req, engine="brute"))["ok"] and cached() == 2
    assert srv._scenes[next(reversed(srv._scenes))][2] is None   # brute
    srv.handle(req)                                   # entry/auto is newest
    assert srv.handle(dict(req, scene=scenes["other"]))["ok"]
    assert cached() == 2
    keys = list(srv._scenes)
    assert [k[2] for k in keys] == ["auto", "auto"]   # the brute entry went
    # a touched file is another key: its old entry ages out
    st = os.stat(scenes["other"])
    os.utime(scenes["other"], ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    assert srv.handle(dict(req, scene=scenes["other"]))["ok"]
    assert cached() == 2 and list(srv._scenes)[0] == keys[1]
    assert srv.handle({"cmd": "stats"})["renders"] == 6


def test_camera_index(server, tmp_path, scenes):
    r = server.handle({"scene": scenes["two_cams"], "out_dir": str(tmp_path),
                       "camera": 1})
    assert r["ok"], r
    assert [os.path.basename(p) for p in r["images"]] == ["top.ppm"]
    r = server.handle({"scene": scenes["two_cams"], "out_dir": str(tmp_path)})
    assert [os.path.basename(p) for p in r["images"]] == ["entry_scene.ppm",
                                                           "top.ppm"]


def test_error_reported_not_raised(server, tmp_path):
    r = server.handle({"scene": str(tmp_path / "nonexistent.xml"),
                       "out_dir": str(tmp_path), "id": 7})
    assert r["ok"] is False and r["id"] == 7
    assert r["error"].startswith("FileNotFoundError: ")
    r = server.handle({"out_dir": str(tmp_path)})
    assert r["ok"] is False and r["error"].startswith("KeyError: ")


def test_tone_request(server, tmp_path):
    r = server.handle({"scene": ENTRY_XML, "out_dir": str(tmp_path),
                       "format": "png", "tone": "aces"})
    assert r["ok"], r
    assert r["images"][0].endswith(".png")
    assert os.path.getsize(r["images"][0]) > 0


def test_bad_ssaa_mode_rejected(server, tmp_path):
    """A misspelled mode is an error answer, not another render."""
    r = server.handle({"scene": ENTRY_XML, "out_dir": str(tmp_path),
                       "ssaa": 2, "ssaa_mode": "pairty"})
    assert not r["ok"] and "ssaa_mode" in r["error"]


def test_adaptive_via_server(server, tmp_path):
    r = server.handle({"scene": ENTRY_XML, "out_dir": str(tmp_path),
                       "ssaa_mode": "adaptive", "ssaa": 2,
                       "adaptive_rounds": 2, "engine": "brute"})
    assert r["ok"], r
    assert r["adaptive"]["rounds"] == 2


def test_server_mesh_matches_single_device(tmp_path):
    """A 4-shard CPU mesh gives the single-device image bit for bit."""
    from raytracer_tpu_torch.serve import RenderServer
    from raytracer_tpu_torch.utils.ppm import read_ppm

    req = {"scene": ENTRY_XML, "ssaa": 2, "engine": "cluster"}
    one = RenderServer(mesh="1", device="cpu")
    four = RenderServer(mesh="4", device="cpu")
    assert one.mesh is None and four.mesh.size == 4
    r1 = one.handle(dict(req, out_dir=str(tmp_path / "one")))
    r4 = four.handle(dict(req, out_dir=str(tmp_path / "four")))
    assert r1["ok"] and r4["ok"], (r1, r4)
    np.testing.assert_array_equal(read_ppm(r1["images"][0]),
                                  read_ppm(r4["images"][0]))


def test_stdin_protocol_subprocess(tmp_path):
    reqs = "\n".join([
        json.dumps({"cmd": "ping"}),
        "not json",
        json.dumps({"scene": ENTRY_XML, "out_dir": str(tmp_path), "id": "sub"}),
        json.dumps({"cmd": "shutdown"}),
        json.dumps({"cmd": "ping"}),      # after shutdown: never answered
    ]) + "\n"
    out = subprocess.run(
        [sys.executable, "-m", "raytracer_tpu_torch.serve", "--device", "cpu",
         "--warmup", ENTRY_XML],
        input=reqs, capture_output=True, text=True, timeout=120, env=_env(),
        cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    lines = [json.loads(line) for line in out.stdout.strip().splitlines()]
    assert lines[0] == {"ready": True}
    assert lines[1]["ok"] and "pong" in lines[1]
    assert lines[2]["ok"] is False and "bad json" in lines[2]["error"]
    assert lines[3]["ok"] and lines[3]["id"] == "sub", lines[3]
    assert lines[4] == {"ok": True, "shutdown": True} and len(lines) == 5
    assert (tmp_path / "entry_scene.ppm").exists()
    assert json.loads(out.stderr.strip().splitlines()[-1])["warmup"] is True


def _ask(f, req):
    f.write(json.dumps(req) + "\n")
    f.flush()
    return json.loads(f.readline())


def test_tcp_port0_survives_dropped_client(tmp_path):
    """``--port 0`` prints the port it bound; a client that drops before
    its answer leaves the server up for the next one."""
    p = subprocess.Popen(
        [sys.executable, "-m", "raytracer_tpu_torch.serve", "--device", "cpu",
         "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env(),
        cwd=str(tmp_path))
    try:
        ready = json.loads(p.stdout.readline())
        assert ready["ready"] and ready["port"] > 0
        addr = ("127.0.0.1", ready["port"])
        with socket.create_connection(addr, timeout=60) as s, \
                s.makefile("rw", encoding="utf-8") as f:
            r = _ask(f, {"scene": ENTRY_XML, "out_dir": str(tmp_path)})
            assert r["ok"], r
        with socket.create_connection(addr, timeout=60) as s:
            s.sendall((json.dumps({"scene": ENTRY_XML, "ssaa": 2,
                                   "out_dir": str(tmp_path)}) + "\n").encode())
            s.shutdown(socket.SHUT_RDWR)
        with socket.create_connection(addr, timeout=60) as s, \
                s.makefile("rw", encoding="utf-8") as f:
            assert _ask(f, {"cmd": "ping"})["ok"]
            assert _ask(f, {"cmd": "shutdown"})["shutdown"]
        assert p.wait(timeout=60) == 0
    finally:
        if p.poll() is None:
            p.kill()
        p.wait()
        p.stdout.close()
        p.stderr.close()


def test_server_matches_jax_server(tmp_path):
    """The port's server against the JAX package's on the entry scene, at
    --ssaa 1 and 2, and at 2 in the jitter and adaptive modes under one
    ``"seed"`` (the port draws the JAX package's samples): the image bars
    (at most 4 pixels > 1 LSB)."""
    from raytracer_tpu.serve import RenderServer as JaxServer
    from raytracer_tpu_torch.serve import RenderServer
    from raytracer_tpu_torch.utils.ppm import read_ppm

    port = RenderServer(mesh="1", device="cpu")
    ref = JaxServer(mesh="1")
    for i, extra in enumerate(({"ssaa": 1}, {"ssaa": 2},
                               {"ssaa": 2, "ssaa_mode": "jitter", "seed": 3},
                               {"ssaa": 2, "ssaa_mode": "adaptive", "seed": 3})):
        req = {"scene": ENTRY_XML, **extra}
        a = port.handle(dict(req, out_dir=str(tmp_path / f"port{i}")))
        b = ref.handle(dict(req, out_dir=str(tmp_path / f"jax{i}")))
        assert a["ok"] and b["ok"], (a, b)
        ia, ib = read_ppm(a["images"][0]), read_ppm(b["images"][0])
        assert ia.shape == ib.shape == (64, 64, 3)
        assert bad_pixels(ia, ib) <= 4
