"""The generators are frozen: deterministic per seed, at the counts the
configurations state, and loaded by the port as its users load XML."""

from __future__ import annotations

import numpy as np

from benchmark import sceneio


def test_horse31k_counts_and_determinism(bench):
    cfg = bench.config("horse31k")
    a = sceneio.generate(bench, cfg, 2**31 + 3)
    b = sceneio.generate(bench, cfg, 2**31 + 3)
    c = sceneio.generate(bench, cfg, 5)
    assert a["vertices"] == b["vertices"]
    assert a["vertices"] != c["vertices"]
    assert sum(len(f) for _, f in a["meshes"]) == cfg["triangles"] == 31_582
    assert len(a["meshes"]) == cfg["meshes"] == 4
    assert len(a["spheres"]) == cfg["spheres"] == 2
    assert len(a["materials"]) == cfg["materials"] == 6
    mirrors = [i + 1 for i, m in enumerate(a["materials"]) if m["is_mirror"]]
    assert len(mirrors) == cfg["mirror_materials"] == 4
    # every material is used: three mirror meshes, the diffuse one, and
    # a diffuse and a mirror sphere
    used = [m for m, _ in a["meshes"]] + [sp[0] for sp in a["spheres"]]
    assert sorted(used) == [1, 2, 3, 4, 5, 6]
    assert len(a["point_lights"]) == cfg["lights"] == 2
    assert a["max_depth"] == 2 and not a["triangles"]
    assert [(k["width"], k["height"]) for k in a["cameras"]] == [(1440, 720)]
    assert cfg["reduced"] == []
    for key in ("triangles", "spheres", "materials", "mirror_materials",
                "lights", "width", "height", "max_depth", "ssaa"):
        assert cfg[key] == cfg["published"][key], key

def test_marbles650_counts_and_determinism(bench):
    cfg = bench.config("marbles650")
    a = sceneio.generate(bench, cfg, 9)
    assert a == sceneio.generate(bench, cfg, 9)
    assert a["vertices"] != sceneio.generate(bench, cfg, 10)["vertices"]
    assert len(a["spheres"]) == cfg["spheres"] == 650
    assert len(a["materials"]) == 6
    assert all(m["is_mirror"] for m in a["materials"])
    assert a["max_depth"] == 6 and len(a["point_lights"]) == 2
    assert not a["meshes"] and not a["triangles"]
    c = np.asarray(a["vertices"]).reshape(-1, 3)
    r = np.array([s[2] for s in a["spheres"]])
    d = np.linalg.norm(c[:, None] - c[None], axis=-1) - r[:, None] - r[None]
    np.fill_diagonal(d, 1.0)
    assert d.min() > 0                        # no two spheres touch


def test_xml_round_trip_through_the_port(bench, tmp_path):
    from raytracer_tpu_torch.utils.xml_ingest import parse_xml

    for name in ("horse31k", "marbles650"):
        parsed = sceneio.generate(bench, bench.config(name), 4)
        path = str(tmp_path / f"{name}.xml")
        sceneio.write_xml(parsed, path)
        back = parse_xml(path)
        assert np.array_equal(np.float32(back["vertices"]).ravel(),
                              np.float32(parsed["vertices"]).ravel())
        assert [tuple(map(tuple, f)) for _, f in back["meshes"]] == [
            tuple(map(tuple, np.asarray(f))) for _, f in parsed["meshes"]]
        assert back["spheres"] == [tuple(s) for s in parsed["spheres"]]
        assert len(back["cameras"]) == len(parsed["cameras"])
