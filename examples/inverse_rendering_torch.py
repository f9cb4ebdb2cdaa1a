"""Inverse rendering through the PyTorch port's public API: recover a
scene's diffuse albedos from a target image.

The target is the scene rendered at 64x64; the albedos are then scaled by
0.25 and raised by 0.05, and 200 Adam steps (lr 3e-2) on the L2 image loss
bring them back, with the rays split over every card of the process
(``make_mesh()``).

    python examples/inverse_rendering_torch.py [scene.xml] [engine]

``engine`` is cluster (the default: the CUDA kernels find the hits, the
shading is differentiated), bvh or brute; the scene defaults to the
repo's tests/data/entry_scene.xml.  ``main(scene, engine, steps,
device)`` returns the losses; ``device="cpu"`` runs the plain PyTorch
versions of the kernels.
"""

from __future__ import annotations

import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from raytracer_tpu_torch import (  # noqa: E402
    build_bvh, build_clusters, load_scene, render_camera,
)
from raytracer_tpu_torch.backend import resolve_device  # noqa: E402
from raytracer_tpu_torch.models.bvh import device_bvh  # noqa: E402
from raytracer_tpu_torch.ops import eye_rays  # noqa: E402
from raytracer_tpu_torch.parallel import (  # noqa: E402
    init_state, make_mesh, make_train_step,
)

DEFAULT_SCENE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "data", "entry_scene.xml")


def main(scene: str = DEFAULT_SCENE, engine: str = "cluster",
         steps: int = 200, device="cuda") -> list:
    dev = resolve_device(device)
    data, meta = load_scene(scene, device=dev)
    cam = dataclasses.replace(meta.cameras[0], width=64, height=64)
    origin, dirs = eye_rays(cam, device=dev)
    accel = None
    if engine == "cluster":
        accel = build_clusters(data, meta, build_bvh(data, meta))
    elif engine == "bvh":
        accel = device_bvh(build_bvh(data, meta, ordered=True), dev)

    # ground-truth target from the unperturbed scene
    with torch.no_grad():
        target = render_camera(data, meta, cam, accel, device=dev,
                               engine=engine).reshape(-1, 3)

    # corrupt the parameter the optimizer must recover (the loss scale:
    # radiance is O(100), albedo O(1))
    data_bad = dataclasses.replace(data, mat_diffuse=data.mat_diffuse * 0.25 + 0.05)

    mesh = make_mesh() if dev.type == "cuda" else make_mesh(devices=[dev])
    print(f"devices: {mesh.size}  scene: {scene}  rays/step: {dirs.shape[0]}")

    # train ONLY the corrupted field; free geometry or lights would wander
    state = init_state(data_bad, fields=("mat_diffuse",))
    step = make_train_step(meta, lr=3e-2, engine=engine, device=dev, mesh=mesh)
    losses = []
    for i in range(steps):
        state, loss = step(state, data_bad, origin, dirs, target, accel)
        losses.append(float(loss))
        if i % 20 == 0 or i == steps - 1:
            print(f"step {i:4d}  loss {losses[-1]:.6f}")

    n = meta.n_materials
    true_diffuse = data.mat_diffuse[:n].double().cpu().numpy()
    got_diffuse = state.params["mat_diffuse"][:n].detach().double().cpu().numpy()
    print("true diffuse:", true_diffuse.round(3).tolist())
    print("recovered   :", got_diffuse.round(3).tolist())
    return losses


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else DEFAULT_SCENE,
         sys.argv[2] if len(sys.argv) > 2 else "cluster")
