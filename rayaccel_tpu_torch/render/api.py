"""racc::render-shaped frame entry point.

Counterpart of ``rayaccel_tpu/render/api.py`` (reference
RayAccelerator.h:115, RayAccelerator.cpp:738-759): a frame is a plain
function call on a renderer, which carries the spawn and shade behaviour.
"""

from __future__ import annotations

from rayaccel_tpu_torch import rng
from rayaccel_tpu_torch.context import Context
from rayaccel_tpu_torch.render.pathtracer import bind_scene
from rayaccel_tpu_torch.types import Stats


def render(context: Context, scene, environment, renderer,
           key=None) -> Stats:
    """Render one progressive frame through ``renderer`` (a TiledRenderer
    subclass). ``scene`` (a compiled scene) and ``environment`` replace the
    renderer's bindings when given and not the objects already bound, as
    the reference re-publishes them per frame (RayAccelerator.cpp:741-746).

    The renderers read their scene and environment afresh every frame and
    cache nothing derived from them, so a rebind is an assignment. A scene
    that ``bind_scene`` would trace on another engine than the renderer's
    is refused. With no ``key``, the frame draws ``rng.PRNGKey(spp)``.
    The JAX function's mesh branch has no counterpart: ``Configuration``
    already raises ``NotImplementedError`` for ``mesh_shape`` (ROADMAP
    queue 1 item 15), so no context here has a mesh."""
    if scene is not None and scene is not renderer.scene:
        backend, bound = bind_scene(renderer.backend, renderer.scene_data,
                                    scene, renderer.device)
        if backend != renderer.backend:
            raise ValueError(
                f"a {type(scene).__name__} runs on the {backend!r} engine, "
                f"not on this renderer's {renderer.backend!r}")
        renderer.scene = bound
    if environment is not None and environment is not renderer.environment:
        renderer.environment = environment
    if key is None:
        key = rng.PRNGKey(renderer.spp)
    return renderer.render_frame(key)
