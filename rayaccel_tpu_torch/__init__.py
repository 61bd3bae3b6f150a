"""rayaccel_tpu_torch — the PyTorch/CUDA port of rayaccel_tpu.

A second package beside the JAX one, for one NVIDIA Hopper GPU (sm_90a).
Each module names its counterpart in ``rayaccel_tpu/`` by file; the JAX
package is the reference the port is tested against. The port imports
``torch`` and never ``jax``.

Two renderers run: ``PathTracingRenderer`` (the headline path tracer) and
``WhittedRenderer`` (ray trees, with optional shadow rays). By default
both trace primaries on the dense work-queue engine and bounces on the
sparse pair engine, in one frame-pooled bounce loop; ``Configuration``
picks another engine (``backend="mxu"``, ``"sparse"`` or ``"xla"``), the
stratified sampler (``sampler="stratified"``) or the per-wave path
(``regroup=False``). The four TPU kernels (closest hit and any hit on the
dense queue, the nearest-k select and the pair kernel) are hand-written
CUDA kernels (``csrc/``), built by nvcc at first use on a CUDA tensor; on
CPU tensors each wrapper runs its plain PyTorch version instead. The
"mxu", "xla" and "bruteforce" engines are plain tensor code on either
device, as they are plain XLA in the JAX package. ``load_scene`` /
``save_scene`` read and write the demo's scene files. ``create_context``
runs on the current CUDA device unless it is given ``device="cpu"``; it
raises when no CUDA device is visible and no device is named. With
``Configuration(mesh_shape=(D,))`` the frame is split over the D ranks of
a ``torch.distributed`` process group, one process a rank (``parallel/``:
NCCL on the card, gloo on the CPU; ``torchrun --nproc_per_node=D``). The
app shell is ``python -m rayaccel_tpu_torch.cli`` (``utils/``: image
output, stats, checkpoints, stage profiling, the live viewer)::

    import rayaccel_tpu_torch as racc
    from rayaccel_tpu_torch import rng
    from rayaccel_tpu_torch.scene.loader import make_battlefield_like
    ctx = racc.create_context(racc.default_configuration())   # on the card
    sd = make_battlefield_like(max_depth=2)
    cam = racc.Camera.look_at(sd.cam_origin, sd.cam_dir, sd.cam_up,
                              sd.cam_fov, sd.viewport_width,
                              sd.viewport_height)
    r = racc.PathTracingRenderer(ctx, cam, sd)   # or racc.WhittedRenderer
    r.render_frame(rng.PRNGKey(0))
    img = r.image()
"""

from rayaccel_tpu_torch.config import (Configuration, ContextInfo,
                                       EngineOpts, default_configuration)
from rayaccel_tpu_torch.context import (Context, create_context, deinit,
                                        destroy, info, init)
from rayaccel_tpu_torch.types import Hits, INVALID_TRIANGLE, Rays, Stats
from rayaccel_tpu_torch.camera import Camera
from rayaccel_tpu_torch.environment import Environment, create_environment
from rayaccel_tpu_torch.materials import (MaterialTable, default_materials,
                                          make_material_table,
                                          reflective_diffuse)
from rayaccel_tpu_torch.scene import (ClusterScene, SceneData, TpuScene,
                                      compile_clusters, compile_scene,
                                      create_scene, load_scene, save_scene)
from rayaccel_tpu_torch.ops.trace import trace
from rayaccel_tpu_torch.render.api import render
from rayaccel_tpu_torch.render.tiled import TiledRenderer
from rayaccel_tpu_torch.render.pathtracer import PathTracingRenderer
from rayaccel_tpu_torch.render.whitted import WhittedRenderer

__all__ = [
    "Configuration", "ContextInfo", "EngineOpts", "default_configuration",
    "Context", "create_context", "destroy", "info", "init", "deinit",
    "Rays", "Hits", "Stats", "INVALID_TRIANGLE",
    "Camera", "Environment", "create_environment",
    "MaterialTable", "reflective_diffuse", "make_material_table",
    "default_materials",
    "ClusterScene", "SceneData", "TpuScene", "compile_clusters",
    "compile_scene", "create_scene", "load_scene", "save_scene", "trace",
    "render", "TiledRenderer", "PathTracingRenderer", "WhittedRenderer",
]

__version__ = "0.1.0"
