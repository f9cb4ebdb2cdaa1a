"""raytracer_tpu_torch stands alone: it imports neither JAX nor the JAX
package, it runs on CUDA unless asked for the CPU, and its kernel
wrappers never fall back to a plain version for a non-CPU tensor."""

import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "raytracer_tpu_torch")


def test_render_loads_no_jax(tmp_path):
    """In a fresh interpreter (this one has JAX loaded by conftest.py):
    import the port and render the entry scene on the CPU."""
    code = (
        "import sys\n"
        "from raytracer_tpu_torch.render import main\n"
        f"main([{os.path.join(REPO, 'tests', 'data', 'entry_scene.xml')!r}, "
        f"'--ssaa', '1', '--device', 'cpu', '--out-dir', {str(tmp_path)!r}])\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib')) or m == 'raytracer_tpu' or m.startswith('raytracer_tpu.'))\n"
        "print('LOADED', bad)\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout
    assert (tmp_path / "entry_scene.ppm").exists()


def test_every_module_loads_no_jax(tmp_path):
    """In a fresh interpreter: import every module of the port (the
    adaptive sampler, the PNG/EXR writers, the accel cache, the diff CLI,
    the brute and BVH engines, training, the mesh, the process group,
    sharded rendering, scaling and the render server among them) and run
    the CLI in the adaptive mode to PNG and the diff CLI on its output."""
    mods = sorted(
        os.path.relpath(p, REPO)[:-3].replace(os.sep, ".").removesuffix(".__init__")
        for p in _sources() if p.startswith(PKG))
    assert {"raytracer_tpu_torch.ops.adaptive", "raytracer_tpu_torch.utils.png",
            "raytracer_tpu_torch.utils.exr", "raytracer_tpu_torch.utils.checkpoint",
            "raytracer_tpu_torch.compare", "raytracer_tpu_torch.ops.intersect",
            "raytracer_tpu_torch.ops.traverse", "raytracer_tpu_torch.parallel.train",
            "raytracer_tpu_torch.train", "raytracer_tpu_torch.serve",
            "raytracer_tpu_torch.parallel.mesh",
            "raytracer_tpu_torch.parallel.render",
            "raytracer_tpu_torch.parallel.distributed",
            "raytracer_tpu_torch.parallel.scaling"} <= set(mods)
    png = os.path.join(str(tmp_path), "entry_scene.png")
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "from raytracer_tpu_torch.render import main\n"
        "from raytracer_tpu_torch.compare import main as compare\n"
        f"main([{os.path.join(REPO, 'tests', 'data', 'entry_scene.xml')!r}, "
        "'--ssaa-mode', 'adaptive', '--format', 'png', '--device', 'cpu', "
        f"'--out-dir', {str(tmp_path)!r}])\n"
        f"assert compare([{png!r}, {png!r}]) == 0\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib')) or m == 'raytracer_tpu' or m.startswith('raytracer_tpu.'))\n"
        "print('LOADED', bad)\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def _sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "examples", "inverse_rendering_torch.py")


def test_sources_import_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|raytracer_tpu)(\.|\s|$)",
                     re.M)
    found = []
    for path in _sources():
        with open(path) as f:
            found += [f"{path}: {m.group(0).strip()}" for m in pat.finditer(f.read())]
    assert not found, found


def test_default_device_raises_without_cuda(monkeypatch):
    from raytracer_tpu_torch import backend
    from raytracer_tpu_torch.models.whitted import render_camera
    from raytracer_tpu_torch.pipeline import render_one_camera
    from raytracer_tpu_torch.render import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        backend.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([os.path.join(REPO, "tests", "data", "entry_scene.xml")])
    for fn in (render_camera, render_one_camera):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(None, None, None, None)
    from raytracer_tpu_torch.ops.random import uniform

    with pytest.raises(RuntimeError, match="no CUDA device"):
        uniform((0, 3), (4, 2))
    from raytracer_tpu_torch.parallel.mesh import mesh_from_arg
    from raytracer_tpu_torch.serve import RenderServer

    for fn in (mesh_from_arg, RenderServer):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    assert backend.resolve_device("cpu") == torch.device("cpu")


def test_wrappers_dispatch_on_tensor_device(monkeypatch):
    """CPU tensors take the plain version and count no launch; any other
    device goes to the kernel, and a kernel library that cannot be built
    raises instead of falling back."""
    from raytracer_tpu_torch import backend
    from raytracer_tpu_torch.ops import kernels as K

    act = torch.ones(1, dtype=torch.int32)
    sup = torch.ones(1, dtype=torch.int32)
    box = torch.zeros((8, 3))
    bundle = torch.zeros((8, 128))
    z = torch.zeros(1, dtype=torch.int32)
    lists = (z, torch.zeros(48, dtype=torch.int32), z, z,
             torch.zeros(8, dtype=torch.int32), z)
    rays = torch.zeros((128, 3))
    any_args = (*lists, rays, rays, torch.ones(128), torch.zeros((12, 128)),
                torch.zeros((4, 128)))
    K.reset_launches()
    assert set(K.launches) == {"ray_mask", "ray_mask_hier", "closest_shared",
                               "closest", "shadow", "any", "threefry",
                               "hit_record", "shade_bounce", "compact",
                               "tile_mask"}
    hit, ent = K.ray_mask(act, box, bundle)
    words, ids, elist, counts = K.compact(hit != 0, ent, 48)
    assert words.shape == (1,) and ids.shape == elist.shape == (48,)
    assert hit.shape == (1, 3) and ent.dtype == torch.float32
    hit, ent = K.ray_mask_hier(act, sup, box, bundle)
    assert hit.shape == (1, 3) and ent.dtype == torch.float32
    found = K.any_hit(*any_args)
    assert found.shape == (128,) and found.dtype == torch.int32
    u = K.threefry_uniform(0, 3, 10, -0.5, 0.5, "cpu")
    assert u.shape == (10,) and u.dtype == torch.float32
    boxes = torch.zeros((3, 3))
    th, te = K.tile_mask(rays, rays, None, boxes, boxes + 1.0, None, 128)
    assert th.shape == (1, 3) and th.dtype == torch.bool
    assert te.dtype == torch.float32
    assert sum(K.launches.values()) == 0

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(backend, "_state", {})
    monkeypatch.setattr(backend, "library_path", lambda: "/nonexistent/lib.so")
    monkeypatch.setattr(backend, "_nvcc", no_nvcc)
    meta = [x.to("meta") for x in (act, box, bundle)]
    with pytest.raises(RuntimeError, match="nvcc"):
        K.ray_mask(*meta)
    with pytest.raises(RuntimeError, match="nvcc"):
        K.ray_mask_hier(meta[0], sup.to("meta"), *meta[1:])
    with pytest.raises(RuntimeError, match="nvcc"):
        K.any_hit(*[x.to("meta") for x in any_args])
    with pytest.raises(RuntimeError, match="nvcc"):
        K.threefry_uniform(0, 3, 10, -0.5, 0.5, "meta")
    with pytest.raises(RuntimeError, match="nvcc"):
        K.compact((hit != 0).to("meta"), ent.to("meta"), 48)
    with pytest.raises(RuntimeError, match="nvcc"):
        K.tile_mask(*[x.to("meta") for x in (rays, rays)], None,
                    boxes.to("meta"), boxes.to("meta"), None, 128)
    assert sum(K.launches.values()) == 0
