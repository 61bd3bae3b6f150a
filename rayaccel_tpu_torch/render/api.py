"""racc::render-shaped frame entry point.

Counterpart of ``rayaccel_tpu/render/api.py`` (reference
RayAccelerator.h:115, RayAccelerator.cpp:738-759): a frame is a plain
function call on a renderer, which carries the spawn and shade behaviour.
"""

from __future__ import annotations

from rayaccel_tpu_torch import rng
from rayaccel_tpu_torch.context import Context
from rayaccel_tpu_torch.render.tiled import bind_scene
from rayaccel_tpu_torch.types import Stats


def render(context: Context, scene, environment, renderer,
           key=None) -> Stats:
    """Render one progressive frame through ``renderer`` (a TiledRenderer
    subclass). ``scene`` (a compiled scene) and ``environment`` replace the
    renderer's bindings when given and not the objects already bound, as
    the reference re-publishes them per frame (RayAccelerator.cpp:741-746).

    The renderers read their scene and environment afresh every frame and
    cache nothing derived from them, so a rebind is an assignment (and a
    copy to the renderer's device of what lies elsewhere). A scene
    that ``bind_scene`` would trace on another engine than the renderer's
    is refused. Under a mesh a rebind replicates rank 0's new scene and
    environment on every rank (``rayaccel_tpu/render/api.py:46-52``), a
    collective: every rank re-publishes the same way. Re-passing the bound
    objects replicates nothing. With no ``key``, the frame draws
    ``rng.PRNGKey(spp)``."""
    new_scene, new_env = renderer._bound_scene, renderer._bound_env
    if scene is not None and scene is not new_scene:
        backend, new_scene = bind_scene(renderer.backend, renderer.scene_data,
                                        scene, renderer.device)
        if backend != renderer.backend:
            raise ValueError(
                f"a {type(scene).__name__} runs on the {backend!r} engine, "
                f"not on this renderer's {renderer.backend!r}")
    if environment is not None:
        new_env = environment
    if (new_scene is not renderer._bound_scene
            or new_env is not renderer._bound_env):
        renderer._bind(new_scene, new_env)
    if key is None:
        key = rng.PRNGKey(renderer.spp)
    return renderer.render_frame(key)
