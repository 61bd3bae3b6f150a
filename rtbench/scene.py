"""The benchmark's scene, its boxes placed from a seed (the
configuration's ``layout_seed``): a frozen copy of the
battlefield-like generator (``rayaccel_tpu_torch/scene/loader.py:
make_battlefield_like`` and its helpers), so that a change to the program
cannot change the inputs it is measured on.

The arrays are plain NumPy. The harness hands them to the program as its
``SceneData``; the reference reads them as they are. Nothing here imports
the program. A configuration may bring a generator of its own as a file
under ``rtbench/scenes/`` (``find``).
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np

# The four demo materials (reference main.cpp:163-168): [kr, kg, kb, eta].
MATERIALS = np.array([
    [0.8, 0.8, 0.8, 1.0 / 1.4],
    [0.1, 0.1, 0.1, 1.0 / 1.4],
    [0.6, 0.6, 0.6, 1.0 / 1.2],
    [0.3, 0.3, 0.3, 1.0 / 1.2],
], np.float32)
CAMERA = ((20.0, 14.0, 42.0), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0), 60.0)


def gradient_environment(width: int = 128, height: int = 64,
                         horizon=(1.0, 0.9, 0.7),
                         zenith=(0.3, 0.5, 0.9)) -> np.ndarray:
    """A sky-gradient angular probe, (H, W, 4) float32."""
    y = np.linspace(0.0, 1.0, height, dtype=np.float32)[:, None, None]
    h = np.asarray(horizon, np.float32)
    z = np.asarray(zenith, np.float32)
    rgb = z[None, None] * (1 - y) + h[None, None] * y
    rgb = np.broadcast_to(rgb, (height, width, 3))
    out = np.ones((height, width, 4), np.float32)
    out[..., :3] = rgb
    return out


def _terrain(x, z):
    return (np.sin(x * 0.35) * np.cos(z * 0.3) * 1.2
            + np.sin(x * 0.11 + 1.0) * 2.0)


def _grid_mesh(n: int, extent: float):
    xs = np.linspace(-extent, extent, n, dtype=np.float32)
    X, Z = np.meshgrid(xs, xs, indexing="ij")
    Y = _terrain(X, Z).astype(np.float32)
    verts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=-1)
    i = np.arange(n - 1)[:, None]
    j = np.arange(n - 1)[None, :]
    v00 = (i * n + j).ravel()
    v10 = ((i + 1) * n + j).ravel()
    v01 = (i * n + (j + 1)).ravel()
    v11 = ((i + 1) * n + (j + 1)).ravel()
    tris = np.concatenate([np.stack([v00, v10, v11], axis=-1),
                           np.stack([v00, v11, v01], axis=-1)])
    return verts, tris.astype(np.uint32)


def _box(center, size):
    c = np.asarray(center, np.float32)
    s = np.asarray(size, np.float32) * 0.5
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                        for z in (-1, 1)], np.float32) * s + c
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
             (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    tris = []
    for a, b, cc, d in quads:
        tris += [[a, b, cc], [a, cc, d]]
    return corners, np.array(tris, np.uint32)


def _face_normals(v, idx):
    n = np.cross(v[idx[:, 1]] - v[idx[:, 0]], v[idx[:, 2]] - v[idx[:, 0]])
    length = np.linalg.norm(n, axis=-1, keepdims=True)
    return (n / np.maximum(length, 1e-20)).astype(np.float32)


def _vertex_normals(v, idx):
    fn = np.cross(v[idx[:, 1]] - v[idx[:, 0]], v[idx[:, 2]] - v[idx[:, 0]])
    out = np.zeros_like(v)
    for k in range(3):
        np.add.at(out, idx[:, k], fn)
    length = np.linalg.norm(out, axis=-1, keepdims=True)
    return (out / np.maximum(length, 1e-20)).astype(np.float32)


def battlefield_like(seed: int, n_objects: int = 600, grid: int = 181,
                     viewport=(1280, 720), max_depth: int = 8) -> dict:
    """A bumpy terrain (a ``grid`` x ``grid`` height field) and
    ``n_objects`` boxes placed from ``seed``, with the four demo
    materials, the generator's camera and its sky probe. Returns the
    fields of the program's ``SceneData`` as NumPy arrays and numbers."""
    rng = np.random.default_rng(seed)
    parts = [(*_grid_mesh(grid, 60.0), 0)]
    pos = rng.uniform(-55, 55, size=(n_objects, 2))
    sizes = rng.uniform(0.6, 3.0, size=(n_objects, 3))
    mats = rng.integers(1, 4, size=n_objects)
    for p, s, m in zip(pos, sizes, mats):
        y = _terrain(p[0], p[1]) + s[1] * 0.5
        parts.append((*_box((p[0], y, p[1]), s), int(m)))

    verts, tris, tri_mats, base = [], [], [], 0
    for v, t, m in parts:
        verts.append(v.astype(np.float32))
        tris.append(t + base)
        tri_mats.append(np.full(len(t), m, np.uint16))
        base += len(v)
    vertices = np.concatenate(verts)
    indices = np.concatenate(tris)
    ext = np.abs(vertices).max() + 1e-6
    origin, target, up, fov = CAMERA
    return dict(
        vertices=vertices, indices=indices,
        triangle_materials=np.concatenate(tri_mats),
        triangle_normals=_face_normals(vertices, indices),
        normals=_vertex_normals(vertices, indices),
        texcoords=(vertices[:, [0, 2]] / (2 * ext) + 0.5).astype(np.float32),
        materials=MATERIALS.copy(), max_depth=int(max_depth),
        viewport_width=int(viewport[0]), viewport_height=int(viewport[1]),
        cam_origin=np.asarray(origin, np.float32),
        cam_dir=np.asarray(target, np.float32),
        cam_up=np.asarray(up, np.float32), cam_fov=float(fov),
        env_pixels=gradient_environment())


GENERATORS = {"battlefield_like": battlefield_like}


def find(name: str, here: str):
    """The scene generator named ``name``: a built-in one of
    ``GENERATORS``, else the ``generate`` function of
    ``<here>/scenes/<name>.py``, loaded by path (``rtbench/scenes/README.md``
    states its contract). An unknown name raises ``KeyError``, naming the
    built-in generators and the files found."""
    if name in GENERATORS:
        return GENERATORS[name]
    folder = os.path.join(here, "scenes")
    path = os.path.join(folder, name + ".py")
    if not os.path.isfile(path):
        files = sorted(f[:-3] for f in os.listdir(folder)
                       if f.endswith(".py")) if os.path.isdir(folder) else []
        raise KeyError(f"unknown scene generator {name!r}; built in: "
                       f"{', '.join(sorted(GENERATORS))}; files in "
                       f"{folder}: {', '.join(files) or 'none'}")
    spec = importlib.util.spec_from_file_location(
        "rtbench_scene_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.generate
