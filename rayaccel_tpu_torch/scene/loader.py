"""Binary scene file IO and synthetic scene generation.

Counterpart of ``rayaccel_tpu/scene/loader.py``, copied as NumPy so the
port never imports the JAX package: ``load_scene`` / ``save_scene`` in the
format of the original demo's scene files, and the small test scene and
the battlefield-like benchmark scene, built from the same seeds to the
same arrays.

The file format (packed little-endian):

    header (60 bytes):
        u32 maxDepth, u32 vertexCount, u32 triangleCount,
        u16 viewportWidth, u16 viewportHeight,
        u16 environmentWidth, u16 environmentHeight,
        float3 origin, float3 dir, float3 up, f32 fov
    body (in order):
        u32  indices           [triangleCount*3]
        u16  triangleMaterials [triangleCount]
        f32x4 triangleNormals  [triangleCount]
        f32x4 vertices         [vertexCount]
        f32x4 normals          [vertexCount]
        f32x2 texcoords        [vertexCount]
        f32x4 environmentPixels[envW*envH]

The material table is not in the file: a loaded scene gets the four demo
materials.
"""

from __future__ import annotations

import struct

import numpy as np

from rayaccel_tpu_torch.scene.data import (SceneData, compute_face_normals,
                                           compute_vertex_normals)

_HEADER = struct.Struct("<IIIHHHH3f3f3ff")
DEFAULT_MATERIALS = np.array([
    [0.8, 0.8, 0.8, 1.0 / 1.4],
    [0.1, 0.1, 0.1, 1.0 / 1.4],
    [0.6, 0.6, 0.6, 1.0 / 1.2],
    [0.3, 0.3, 0.3, 1.0 / 1.2],
], np.float32)


def load_scene(path: str) -> SceneData:
    """Load a scene in the binary format of the module docstring."""
    with open(path, "rb") as f:
        raw = f.read(_HEADER.size)
        fields = _HEADER.unpack(raw)
        (max_depth, vertex_count, triangle_count,
         vw, vh, ew, eh) = fields[:7]
        origin = np.array(fields[7:10], np.float32)
        cam_dir = np.array(fields[10:13], np.float32)
        up = np.array(fields[13:16], np.float32)
        fov = fields[16]

        def read(dtype, count, cols=None):
            arr = np.fromfile(f, dtype=dtype, count=count * (cols or 1))
            return arr.reshape(count, cols) if cols else arr

        indices = read(np.uint32, triangle_count, 3)
        tri_mats = read(np.uint16, triangle_count)
        tri_normals = read(np.float32, triangle_count, 4)[:, :3].copy()
        vertices = read(np.float32, vertex_count, 4)[:, :3].copy()
        normals = read(np.float32, vertex_count, 4)[:, :3].copy()
        texcoords = read(np.float32, vertex_count, 2)
        env = read(np.float32, ew * eh, 4).reshape(eh, ew, 4)

    return SceneData(
        vertices=vertices, indices=indices,
        triangle_materials=tri_mats, triangle_normals=tri_normals,
        normals=normals, texcoords=texcoords,
        materials=DEFAULT_MATERIALS.copy(),
        max_depth=int(max_depth),
        viewport_width=int(vw), viewport_height=int(vh),
        cam_origin=origin, cam_dir=cam_dir, cam_up=up, cam_fov=float(fov),
        env_pixels=env,
    ).validate()


def save_scene(path: str, scene: SceneData):
    """Write a scene in the binary format of the module docstring."""
    env = scene.env_pixels
    if env is None:
        env = np.zeros((1, 1, 4), np.float32)
    eh, ew = env.shape[:2]
    origin = scene.cam_origin if scene.cam_origin is not None else np.zeros(3)
    cam_dir = scene.cam_dir if scene.cam_dir is not None else np.array([0, 0, 1.0])
    up = scene.cam_up if scene.cam_up is not None else np.array([0, 1.0, 0])

    def pad4(a):
        out = np.zeros((a.shape[0], 4), np.float32)
        out[:, :3] = a
        return out

    with open(path, "wb") as f:
        f.write(_HEADER.pack(
            scene.max_depth, scene.vertex_count, scene.triangle_count,
            scene.viewport_width, scene.viewport_height, ew, eh,
            *np.asarray(origin, np.float32), *np.asarray(cam_dir, np.float32),
            *np.asarray(up, np.float32), float(scene.cam_fov)))
        scene.indices.astype(np.uint32).tofile(f)
        scene.triangle_materials.astype(np.uint16).tofile(f)
        pad4(scene.triangle_normals).tofile(f)
        pad4(scene.vertices).tofile(f)
        pad4(scene.normals).tofile(f)
        scene.texcoords.astype(np.float32).tofile(f)
        env.astype(np.float32).tofile(f)


# ---------------------------------------------------------------------------
# Synthetic scenes
# ---------------------------------------------------------------------------

def make_gradient_environment(width: int = 64, height: int = 32,
                              horizon=(1.0, 0.9, 0.7), zenith=(0.3, 0.5, 0.9),
                              scale: float = 1.0) -> np.ndarray:
    """A simple sky-gradient angular probe, (H, W, 4) float32."""
    y = np.linspace(0.0, 1.0, height, dtype=np.float32)[:, None, None]
    h = np.asarray(horizon, np.float32) * scale
    z = np.asarray(zenith, np.float32) * scale
    rgb = z[None, None] * (1 - y) + h[None, None] * y
    rgb = np.broadcast_to(rgb, (height, width, 3))
    out = np.ones((height, width, 4), np.float32)
    out[..., :3] = rgb
    return out


def _grid_mesh(nx: int, nz: int, extent: float, height_fn) -> tuple:
    """Triangulated height-field grid."""
    xs = np.linspace(-extent, extent, nx, dtype=np.float32)
    zs = np.linspace(-extent, extent, nz, dtype=np.float32)
    X, Z = np.meshgrid(xs, zs, indexing="ij")
    Y = height_fn(X, Z).astype(np.float32)
    verts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=-1)

    i = np.arange(nx - 1)[:, None]
    j = np.arange(nz - 1)[None, :]
    v00 = (i * nz + j).ravel()
    v10 = ((i + 1) * nz + j).ravel()
    v01 = (i * nz + (j + 1)).ravel()
    v11 = ((i + 1) * nz + (j + 1)).ravel()
    tris = np.concatenate([
        np.stack([v00, v10, v11], axis=-1),
        np.stack([v00, v11, v01], axis=-1),
    ], axis=0).astype(np.uint32)
    return verts, tris


def _box(center, size) -> tuple:
    c = np.asarray(center, np.float32)
    s = np.asarray(size, np.float32) * 0.5
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)],
                       np.float32) * s + c
    # 12 triangles, outward winding.
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
             (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    tris = []
    for a, b, cc, d in quads:
        tris.append([a, b, cc])
        tris.append([a, cc, d])
    return corners, np.array(tris, np.uint32)


def _assemble(parts, materials, max_depth, viewport, camera, env) -> SceneData:
    """parts: list of (verts, tris, material_id)."""
    all_v, all_t, all_m = [], [], []
    base = 0
    for verts, tris, mat in parts:
        all_v.append(verts.astype(np.float32))
        all_t.append(tris.astype(np.uint32) + base)
        all_m.append(np.full(len(tris), mat, np.uint16))
        base += len(verts)
    vertices = np.concatenate(all_v)
    indices = np.concatenate(all_t)
    tri_mats = np.concatenate(all_m)

    # Planar texcoords from xz.
    ext = np.abs(vertices).max() + 1e-6
    texcoords = (vertices[:, [0, 2]] / (2 * ext) + 0.5).astype(np.float32)

    origin, target, up, fov = camera
    return SceneData(
        vertices=vertices, indices=indices,
        triangle_materials=tri_mats,
        triangle_normals=compute_face_normals(vertices, indices),
        normals=compute_vertex_normals(vertices, indices),
        texcoords=texcoords,
        materials=materials,
        max_depth=max_depth,
        viewport_width=viewport[0], viewport_height=viewport[1],
        cam_origin=np.asarray(origin, np.float32),
        cam_dir=np.asarray(target, np.float32),
        cam_up=np.asarray(up, np.float32),
        cam_fov=60.0 if fov is None else fov,
        env_pixels=env,
    ).validate()


def make_test_scene(viewport=(128, 128), max_depth: int = 3) -> SceneData:
    """Small deterministic scene: ground plane + two boxes. ~100 tris."""
    rng = np.random.default_rng(7)
    ground_v, ground_t = _grid_mesh(5, 5, 8.0, lambda x, z: 0.0 * x)
    box1_v, box1_t = _box((0.0, 1.0, 0.0), (2.0, 2.0, 2.0))
    box2_v, box2_t = _box((2.5, 0.6, 1.5), (1.2, 1.2, 1.2))
    del rng
    return _assemble(
        [(ground_v, ground_t, 0), (box1_v, box1_t, 2), (box2_v, box2_t, 3)],
        DEFAULT_MATERIALS.copy(), max_depth, viewport,
        ((6.0, 4.0, 8.0), (0.0, 0.8, 0.0), (0.0, 1.0, 0.0), 55.0),
        make_gradient_environment(),
    )


def make_battlefield_like(n_objects: int = 600, grid: int = 181,
                          viewport=(1280, 720), max_depth: int = 8,
                          seed: int = 42) -> SceneData:
    """Benchmark scene standing in for the missing battlefield.bin blob:
    a bumpy terrain plus a field of boxes, ~100k triangles with the four
    demo materials. Deterministic given the seed.
    """
    rng = np.random.default_rng(seed)

    def terrain(x, z):
        return (np.sin(x * 0.35) * np.cos(z * 0.3) * 1.2
                + np.sin(x * 0.11 + 1.0) * 2.0)

    parts = [(_grid_mesh(grid, grid, 60.0, terrain))[0:2] + (0,)]
    ground_v, ground_t = parts[0][0], parts[0][1]
    parts = [(ground_v, ground_t, 0)]

    pos = rng.uniform(-55, 55, size=(n_objects, 2))
    sizes = rng.uniform(0.6, 3.0, size=(n_objects, 3))
    mats = rng.integers(1, 4, size=n_objects)
    for p, s, m in zip(pos, sizes, mats):
        y = terrain(p[0], p[1]) + s[1] * 0.5
        v, t = _box((p[0], y, p[1]), s)
        parts.append((v, t, int(m)))

    return _assemble(
        parts, DEFAULT_MATERIALS.copy(), max_depth, viewport,
        ((20.0, 14.0, 42.0), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0), 60.0),
        make_gradient_environment(128, 64),
    )
