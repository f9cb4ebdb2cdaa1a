"""The port's outputs and tools against the JAX package's: PNG and EXR
bytes, tone curves, the image-diff CLI, the accel cache in both
directions, and the two CLIs on the entry scene (max depth 3, one light)
in the new formats, tone curves and modes, at the image bars (at most 4
pixels > 1 LSB)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from torch_port_util import ENTRY_XML, bad_pixels, jax_accel, numpy_fields


@pytest.mark.parametrize("shape", [(1, 1, 3), (17, 33, 3), (64, 64, 3)])
def test_png_bytes_match_jax(tmp_path, shape):
    from raytracer_tpu.utils.png import write_png as jwrite
    from raytracer_tpu_torch.utils.png import read_png, write_png

    img = np.random.default_rng(shape[0]).integers(0, 256, shape).astype(np.uint8)
    write_png(str(tmp_path / "p.png"), img)
    jwrite(str(tmp_path / "j.png"), img)
    assert (tmp_path / "p.png").read_bytes() == (tmp_path / "j.png").read_bytes()
    np.testing.assert_array_equal(read_png(str(tmp_path / "p.png")), img)


@pytest.mark.parametrize("half", [True, False])
def test_exr_bytes_match_jax(tmp_path, half):
    """Linear radiance with negatives, large values and subnormal halves:
    the same bytes from both writers."""
    from raytracer_tpu.utils.exr import write_exr as jwrite
    from raytracer_tpu_torch.utils.exr import read_exr, write_exr

    rng = np.random.default_rng(int(half))
    img = (rng.standard_normal((13, 21, 3)) * 10.0 ** rng.integers(-7, 5, (13, 21, 3))
           ).astype(np.float32)
    write_exr(str(tmp_path / "p.exr"), img, half=half)
    jwrite(str(tmp_path / "j.exr"), img, half=half)
    assert (tmp_path / "p.exr").read_bytes() == (tmp_path / "j.exr").read_bytes()
    back = read_exr(str(tmp_path / "p.exr"))
    np.testing.assert_array_equal(back, img.astype(np.float16).astype(np.float32)
                                  if half else img)


@pytest.mark.parametrize("mode", ["none", "gamma", "reinhard", "aces"])
def test_tone_map_matches_jax(mode):
    """Every tone curve within 1 LSB of the JAX package's on radiance from
    below 0 to far past 255."""
    import jax.numpy as jnp

    from raytracer_tpu.ops.image import tone_map as jtone
    from raytracer_tpu_torch.ops.image import TONE_MODES, tone_map

    assert mode in TONE_MODES
    rng = np.random.default_rng(len(mode))
    color = rng.uniform(-20.0, 2000.0, (64, 64, 3)).astype(np.float32)
    color[0, :8] = np.array([0.0, 1e-6, 127.5, 254.5, 255.0, 255.5, 1e6, -1.0])[:, None]
    p = tone_map(torch.from_numpy(color), mode)
    j = np.asarray(jtone(jnp.asarray(color), mode))
    assert p.dtype == torch.uint8
    assert int(np.abs(p.numpy().astype(int) - j.astype(int)).max()) <= 1


def test_tone_map_unknown_mode():
    from raytracer_tpu_torch.ops.image import tone_map

    with pytest.raises(ValueError, match="tone"):
        tone_map(torch.zeros((2, 2, 3)), "filmic")


def _compare_cases(tmp_path):
    """{label: (a, b, extra args)} image pairs for the diff CLIs."""
    from raytracer_tpu_torch.utils.exr import write_exr
    from raytracer_tpu_torch.utils.png import write_png
    from raytracer_tpu_torch.utils.ppm import write_ppm

    rng = np.random.default_rng(4)
    a = rng.integers(0, 256, (12, 10, 3)).astype(np.uint8)
    b = a.copy()
    b[0, 0, 0] ^= 1
    c = 255 - a
    radiance = (rng.random((12, 10, 3)) * 300.0).astype(np.float32)
    paths = {}
    for name, img in (("a", a), ("b", b), ("c", c)):
        paths[name] = str(tmp_path / f"{name}.ppm")
        write_ppm(paths[name], img)
    paths["a_png"] = str(tmp_path / "a.png")
    write_png(paths["a_png"], a)
    paths["r_exr"] = str(tmp_path / "r.exr")
    write_exr(paths["r_exr"], radiance, half=False)
    paths["r_ppm"] = str(tmp_path / "r.ppm")
    write_ppm(paths["r_ppm"], np.floor(np.clip(radiance, 0, 255) + 0.5).astype(np.uint8))
    paths["small"] = str(tmp_path / "small.ppm")
    write_ppm(paths["small"], a[:4])
    return {
        "same": (paths["a"], paths["a"], []),
        "one LSB": (paths["a"], paths["b"], []),
        "one LSB, no tolerance": (paths["a"], paths["b"], ["--frac-tol", "0"]),
        "inverted": (paths["a"], paths["c"], ["--big", "3"]),
        "png vs ppm": (paths["a_png"], paths["a"], []),
        "exr vs ppm": (paths["r_exr"], paths["r_ppm"], ["--frac-tol", "0"]),
        "shape mismatch": (paths["a"], paths["small"], []),
    }


def test_compare_cli_matches_jax(tmp_path, capsys):
    """The same JSON line and exit status as ``raytracer_tpu.compare``."""
    from raytracer_tpu.compare import main as jmain
    from raytracer_tpu_torch.compare import main as pmain

    codes = set()
    for label, (a, b, extra) in _compare_cases(tmp_path).items():
        rc_p = pmain([a, b, *extra])
        out_p = capsys.readouterr().out
        rc_j = jmain([a, b, *extra])
        out_j = capsys.readouterr().out
        assert (rc_p, json.loads(out_p)) == (rc_j, json.loads(out_j)), label
        codes.add(rc_p)
    assert codes == {0, 1}


@pytest.mark.parametrize("scene", ["entry", "terrain16"])
def test_accel_cache_crosses_packages(tmp_path, scene):
    """A cache the JAX package writes loads in the port equal to the port's
    own build (with the octant threads, which the JAX build attaches by
    default), and one the port writes loads in the JAX package equal to
    its build (without them, which the port's cluster build does not
    attach)."""
    import jax

    from raytracer_tpu.utils.checkpoint import load_accel as jload
    from raytracer_tpu.utils.checkpoint import save_accel as jsave
    from raytracer_tpu_torch.models.bvh import build_bvh
    from raytracer_tpu_torch.models.clusters import build_clusters
    from raytracer_tpu_torch.utils.checkpoint import load_accel, save_accel
    from torch_port_util import port_scene

    jdata, jmeta, jbvh, jcs = jax_accel(scene)
    data, meta = port_scene(scene)
    bvh = build_bvh(data, meta)
    cs = build_clusters(data, meta, bvh)
    jsave(str(tmp_path / "jax.npz"), jbvh, jcs)
    save_accel(str(tmp_path / "port.npz"), bvh, cs)

    pbvh, pcs = load_accel(str(tmp_path / "jax.npz"), device="cpu")
    for got, want in ((pbvh, build_bvh(data, meta, ordered=True)), (pcs, cs)):
        for k, v in numpy_fields(want).items():
            np.testing.assert_array_equal(numpy_fields(got)[k], v, err_msg=k)
    assert pcs.tri_dat.device == torch.device("cpu")

    jbvh2, jcs2 = jload(str(tmp_path / "port.npz"))
    assert jbvh2.oct_skip is None
    for k, v in numpy_fields(bvh).items():
        if v is None:       # the octant threads, checked absent above
            continue
        np.testing.assert_array_equal(np.asarray(getattr(jbvh2, k)),
                                      np.asarray(getattr(jbvh, k)), err_msg=k)
    for a, b in zip(jax.tree.leaves(jcs2), jax.tree.leaves(jcs)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert (jcs2.n_tri, jcs2.n_sph) == (jcs.n_tri, jcs.n_sph)


def _run_port_cli(args, capsys):
    from raytracer_tpu_torch.render import main

    main([*args, "--device", "cpu"])
    return capsys.readouterr().out


def test_accel_cache_cli(tmp_path, capsys, monkeypatch):
    """--accel-cache: the first run builds and saves, the second loads
    (builds nothing) and renders the same image; a cache of another
    version, a truncated file, another scene's cache, the cache of this
    scene with one vertex moved (the same primitive counts) and one saved
    without a scene digest (as the JAX package saves it) are each rebuilt
    and overwritten, with one note."""
    from raytracer_tpu_torch import render
    from raytracer_tpu_torch.utils.ppm import read_ppm
    from torch_port_util import SYNTH

    builds = []
    build = render.build_bvh
    monkeypatch.setattr(render, "build_bvh",
                        lambda *a: builds.append(1) or build(*a))
    cache = tmp_path / "accel.npz"
    args = [ENTRY_XML, "--ssaa", "1", "--accel-cache", str(cache)]
    out = _run_port_cli(args + ["--out-dir", str(tmp_path / "a")], capsys)
    assert cache.exists() and len(builds) == 1 and "note" not in out
    out = _run_port_cli(args + ["--out-dir", str(tmp_path / "b")], capsys)
    assert len(builds) == 1 and "note" not in out
    np.testing.assert_array_equal(read_ppm(str(tmp_path / "a" / "entry_scene.ppm")),
                                  read_ppm(str(tmp_path / "b" / "entry_scene.ppm")))
    good = cache.read_bytes()

    with np.load(str(cache)) as z:
        old = {k: z[k] for k in z.files}
    old["accel_version"] = np.int64(4)
    with open(cache, "wb") as f:
        np.savez_compressed(f, **old)
    other = tmp_path / "other.npz"
    from raytracer_tpu_torch.models.bvh import build_bvh
    from raytracer_tpu_torch.models.clusters import build_clusters
    from raytracer_tpu_torch.utils import synth
    from raytracer_tpu_torch.models.scene import load_scene
    from raytracer_tpu_torch.utils.checkpoint import save_accel, scene_digest

    def saved(data, meta, digest=True):
        bvh = build_bvh(data, meta)
        save_accel(str(other), bvh, build_clusters(data, meta, bvh),
                   scene_digest(data) if digest else None)
        return other.read_bytes()

    fn, kw = SYNTH["terrain16"]
    edata, emeta = load_scene(ENTRY_XML, device="cpu")
    moved = edata.vertices.clone()
    moved[0] += 0.25
    stale = {"version 4": None, "truncated": good[:len(good) // 2],
             "another scene": saved(*getattr(synth, fn)(device="cpu", **kw)),
             "one vertex moved": saved(
                 dataclasses.replace(edata, vertices=moved), emeta),
             "no scene digest": saved(edata, emeta, digest=False)}
    for label, content in stale.items():
        if content is not None:
            cache.write_bytes(content)
        n = len(builds)
        out = _run_port_cli(args + ["--out-dir", str(tmp_path / "c")], capsys)
        assert out.count("note: rebuilding the accel cache") == 1, label
        assert len(builds) == n + 1, label
        np.testing.assert_array_equal(
            read_ppm(str(tmp_path / "c" / "entry_scene.ppm")),
            read_ppm(str(tmp_path / "a" / "entry_scene.ppm")), err_msg=label)
        out = _run_port_cli(args + ["--out-dir", str(tmp_path / "d")], capsys)
        assert len(builds) == n + 1 and "note" not in out, label


def _read(path):
    if path.endswith(".png"):
        from raytracer_tpu_torch.utils.png import read_png

        return read_png(path)
    if path.endswith(".exr"):
        from raytracer_tpu_torch.utils.exr import read_exr

        return read_exr(path)
    from raytracer_tpu_torch.utils.ppm import read_ppm

    return read_ppm(path)


@pytest.mark.parametrize("extra,name", [
    (["--format", "png"], "entry_scene.png"),
    (["--format", "exr"], "entry_scene.exr"),
    (["--tone", "aces"], "entry_scene.ppm"),
    (["--tone", "gamma", "--format", "png", "--ssaa-mode", "mean"], "entry_scene.png"),
    (["--chunk", "2048"], "entry_scene.ppm"),
])
def test_cli_formats_match_jax(tmp_path, capsys, extra, name):
    """The port CLI and the JAX CLI (one device) at --ssaa 2: PNG, EXR
    (half floats of linear radiance), tone curves, and a --chunk that
    streams the 16,384-ray frame in 8 bands."""
    from raytracer_tpu.render import main as jmain

    args = [ENTRY_XML, "--ssaa", "2", *extra]
    jmain(args + ["--mesh", "1", "--out-dir", str(tmp_path / "j")])
    capsys.readouterr()
    _run_port_cli(args + ["--out-dir", str(tmp_path / "p")], capsys)
    j = _read(str(tmp_path / "j" / name))
    p = _read(str(tmp_path / "p" / name))
    assert p.shape == j.shape == (64, 64, 3) and p.dtype == j.dtype
    if name.endswith(".exr"):
        q = lambda x: np.floor(np.clip(x, 0, 255) + 0.5).astype(np.uint8)  # noqa: E731
        assert bad_pixels(q(p), q(j)) <= 4
        close = np.isclose(p, j, rtol=1e-3, atol=1e-3).all(-1)
        assert (~close).sum() <= 4
    else:
        assert p.max() > 0
        assert bad_pixels(p, j) <= 4


def _json_lines(out):
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


@pytest.mark.parametrize("mode", ["jitter", "adaptive"])
def test_cli_stochastic_modes(tmp_path, capsys, mode):
    """--ssaa-mode jitter|adaptive through the port CLI: the image's shape,
    the same image under one --seed and another under another, and the
    JAX CLI's image under the same --seed at the image bar (the port draws
    the JAX package's samples); adaptive prints the JAX CLI's
    ``adaptive`` stats in its metrics line."""
    from raytracer_tpu_torch.utils.ppm import read_ppm

    base = [ENTRY_XML, "--ssaa", "2", "--ssaa-mode", mode, "--json-metrics"]
    imgs = []
    for i, seed in enumerate(("5", "5", "6")):
        out = _run_port_cli(base + ["--seed", seed, "--out-dir",
                                    str(tmp_path / str(i))], capsys)
        imgs.append(read_ppm(str(tmp_path / str(i) / "entry_scene.ppm")))
        (line,) = _json_lines(out)
    assert imgs[0].shape == (64, 64, 3) and imgs[0].max() > 0
    np.testing.assert_array_equal(imgs[0], imgs[1])
    assert (imgs[0] != imgs[2]).any()
    from raytracer_tpu.render import main as jmain

    jmain(base + ["--seed", "5", "--mesh", "1", "--out-dir", str(tmp_path / "j")])
    (jline,) = _json_lines(capsys.readouterr().out)
    assert bad_pixels(imgs[0], read_ppm(str(tmp_path / "j" / "entry_scene.ppm"))) <= 4
    if mode == "adaptive":
        assert line["adaptive"] == jline["adaptive"]
        assert line["adaptive"]["mean_spp"] == 5.5
        assert (line["width"], line["height"]) == (64, 64)
    else:
        assert "adaptive" not in line
        assert (line["width"], line["height"]) == (128, 128)


def test_write_image_formats(tmp_path):
    from raytracer_tpu_torch.pipeline import FORMATS, write_image

    img = np.zeros((2, 3, 3), np.uint8)
    assert FORMATS == ("ppm", "png", "exr")
    assert write_image(str(tmp_path), "x.ppm", img).endswith("x.ppm")
    assert write_image(str(tmp_path), "x.ppm", img, "png").endswith("x.png")
    assert write_image(str(tmp_path), "x.ppm", img.astype(np.float32),
                       "exr").endswith("x.exr")
    with pytest.raises(ValueError, match="format"):
        write_image(str(tmp_path), "x.ppm", img, "tga")
