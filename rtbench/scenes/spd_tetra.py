"""Eric Haines' Standard Procedural Database scene ``tetra``: a recursive
tetrahedral pyramid (a Sierpinski tetrahedron), after the SPD's ``tetra.c``
(E. Haines, "A Proposal for Standard Graphics Environments", IEEE CG&A
7(11), 1987).

The pyramid of width 1 about the origin has its corners at the alternate
corners (+1, +1, +1), (+1, -1, -1), (-1, +1, -1) and (-1, -1, +1) of the
cube [-1, 1]^3. Each level replaces a tetrahedron of width w at c by four
of width w / 2 at c + w / 2 times those corners, in that order; after
``size_factor`` levels each of the 4^size_factor tetrahedra is output as
four triangles, so the scene has 4^(size_factor + 1) triangles. Every
coordinate is a sum of powers of two, exact in float32. The triangles
are flat: each has its own three vertices, whose normals are its face's
(the SPD's polygons carry no vertex normals).

What ``tetra.c`` does not give is the program's: one of the four demo
materials for every triangle, the sky probe of ``rtbench/scene.py`` in
place of the SPD's background colour and point lights, and the viewport
(the configuration's ``assumed`` lists each). NumPy only; the same
arguments give the same arrays, byte for byte.
"""

from __future__ import annotations

import numpy as np

from rtbench.scene import MATERIALS, _face_normals, gradient_environment

CORNERS = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]],
                   np.float64)
# The face opposite each corner, wound so that its normal points out.
FACES = np.array([[1, 3, 2], [0, 2, 3], [0, 3, 1], [0, 1, 2]], np.int64)
# The view, provisional until it is tetra.c's own: its from point as
# recalled, looking at the pyramid's centre, 45 degrees high, with +z up
# (see the configuration's ``assumed``).
FROM = (1.022846, -3.177154, -2.174512)
AT = (0.0, 0.0, 0.0)
UP = (0.0, 0.0, 1.0)
FOV = 45.0
MATERIAL = 0


def centres(size_factor: int):
    """(4^size_factor, 3) float64 centres of the smallest tetrahedra, in
    ``tetra.c``'s order of output, and their width."""
    c = np.zeros((1, 3), np.float64)
    width = 1.0
    for _ in range(size_factor):
        width /= 2.0
        c = (c[:, None, :] + width * CORNERS[None, :, :]).reshape(-1, 3)
    return c, width


def generate(layout_seed, *, max_depth, size_factor, viewport) -> dict:
    """The fields of the program's ``SceneData`` as NumPy arrays: the
    pyramid at ``size_factor``, its triangles in ``tetra.c``'s order.
    ``layout_seed`` places nothing: the SPD scene is fixed."""
    del layout_seed
    c, width = centres(int(size_factor))
    corners = c[:, None, :] + width * CORNERS[None, :, :]       # (n, 4, 3)
    vertices = corners[:, FACES, :].reshape(-1, 3).astype(np.float32)
    n_tri = vertices.shape[0] // 3
    indices = np.arange(3 * n_tri, dtype=np.uint32).reshape(n_tri, 3)
    face = _face_normals(vertices, indices)
    normals = np.repeat(face, 3, axis=0)
    ext = np.abs(vertices).max() + 1e-6
    return dict(
        vertices=vertices, indices=indices,
        triangle_materials=np.full(n_tri, MATERIAL, np.uint16),
        triangle_normals=face, normals=normals,
        texcoords=(vertices[:, :2] / (2 * ext) + 0.5).astype(np.float32),
        materials=MATERIALS.copy(), max_depth=int(max_depth),
        viewport_width=int(viewport[0]), viewport_height=int(viewport[1]),
        cam_origin=np.asarray(FROM, np.float32),
        cam_dir=np.asarray(AT, np.float32),
        cam_up=np.asarray(UP, np.float32), cam_fov=float(FOV),
        env_pixels=gradient_environment())
