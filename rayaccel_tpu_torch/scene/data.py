"""Host-side scene attribute container.

Counterpart of ``rayaccel_tpu/scene/data.py`` (NumPy only, copied so the
port never imports the JAX package): geometry indices, per-triangle
material ids and face normals, per-vertex normals and texcoords, the
material table, path depth limit and viewport.
:func:`rayaccel_tpu_torch.scene.clusters.compile_clusters` turns the
geometry into device tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class SceneData:
    # Geometry.
    vertices: np.ndarray            # (V, 3) float32 positions
    indices: np.ndarray             # (T, 3) uint32 triangle vertex indices
    # Per-triangle attributes.
    triangle_materials: np.ndarray  # (T,) uint16 material id
    triangle_normals: np.ndarray    # (T, 3) float32 geometric (face) normals
    # Per-vertex attributes.
    normals: np.ndarray             # (V, 3) float32 shading normals
    texcoords: np.ndarray           # (V, 2) float32
    # Materials: rows of [kr, kg, kb, eta] (see materials.py).
    materials: np.ndarray           # (M, 4) float32
    # Render parameters.
    max_depth: int = 8
    viewport_width: int = 1280
    viewport_height: int = 720
    # Camera parameters (from the scene file header, main.cpp:118-151).
    cam_origin: Optional[np.ndarray] = None   # (3,)
    cam_dir: Optional[np.ndarray] = None      # (3,) look-at target direction
    cam_up: Optional[np.ndarray] = None       # (3,)
    cam_fov: float = 60.0
    # Environment probe pixels, (H, W, 4) float32 (alpha ignored).
    env_pixels: Optional[np.ndarray] = None

    @property
    def triangle_count(self) -> int:
        return int(self.indices.shape[0])

    @property
    def vertex_count(self) -> int:
        return int(self.vertices.shape[0])

    def validate(self):
        T, V = self.triangle_count, self.vertex_count
        assert self.indices.shape == (T, 3)
        assert self.vertices.shape == (V, 3)
        assert self.triangle_materials.shape == (T,)
        assert self.triangle_normals.shape == (T, 3)
        assert self.normals.shape == (V, 3)
        assert self.texcoords.shape == (V, 2)
        assert self.indices.max(initial=0) < V
        assert self.triangle_materials.max(initial=0) < len(self.materials)
        return self


def compute_face_normals(vertices: np.ndarray, indices: np.ndarray) -> np.ndarray:
    v0 = vertices[indices[:, 0]]
    v1 = vertices[indices[:, 1]]
    v2 = vertices[indices[:, 2]]
    n = np.cross(v1 - v0, v2 - v0)
    length = np.linalg.norm(n, axis=-1, keepdims=True)
    return (n / np.maximum(length, 1e-20)).astype(np.float32)


def compute_vertex_normals(vertices: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normal accumulation."""
    v0 = vertices[indices[:, 0]]
    v1 = vertices[indices[:, 1]]
    v2 = vertices[indices[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)  # area-weighted
    out = np.zeros_like(vertices)
    for k in range(3):
        np.add.at(out, indices[:, k], fn)
    length = np.linalg.norm(out, axis=-1, keepdims=True)
    return (out / np.maximum(length, 1e-20)).astype(np.float32)
