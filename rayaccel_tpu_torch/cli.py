"""Command-line renderer.

Counterpart of ``rayaccel_tpu/cli.py``, in the role of the reference demo
app shell (reference main.cpp:284-386): flag parsing, engine selection,
scene loading, the render loop with Mrays/s reporting, checkpoint and
resume, the live viewer, and PNG/PFM output. The reference flags map as
in the JAX CLI:

    --whitted            -> --whitted              (main.cpp:290)
    --no-gpu             -> --backend xla          (main.cpp:293)
    --no-cpu-tracing     -> --backend mxu          (main.cpp:296)

One flag is the port's own: ``--device`` (default: the current CUDA
device). The CLI never picks the CPU by itself; without a CUDA device it
raises unless given ``--device cpu``. Key draws are the JAX CLI's, bit for
bit (:mod:`rayaccel_tpu_torch.rng`).

Usage::

    python -m rayaccel_tpu_torch.cli --synthetic battlefield --spp 4 --out pt.pfm
    python -m rayaccel_tpu_torch.cli --synthetic test --device cpu --out t.png
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rayaccel_tpu_torch",
        description="Wavefront ray tracer on PyTorch and CUDA "
                    "(RayAccelerator capabilities)")
    p.add_argument("--scene", help="scene file in the reference binary format "
                                   "(main.cpp:117-191)")
    p.add_argument("--synthetic", choices=["test", "battlefield"],
                   help="generate a synthetic scene instead of loading one")
    p.add_argument("--whitted", action="store_true",
                   help="use the Whitted renderer (reference --whitted)")
    p.add_argument("--no-gpu", dest="no_gpu", action="store_true",
                   help="disable the cluster throughput engine; use the "
                        "lockstep BVH backend (reference --no-gpu)")
    p.add_argument("--no-cpu-tracing", dest="no_cpu", action="store_true",
                   help="force the plain cluster engine (reference "
                        "--no-cpu-tracing)")
    p.add_argument("--backend", choices=["pallas", "mxu", "xla", "sparse"],
                   default=None, help="explicit traversal backend")
    p.add_argument("--no-hybrid", dest="no_hybrid", action="store_true",
                   help="disable hybrid routing (bounce rays on the sparse "
                        "pair engine); one engine traces everything")
    p.add_argument("--spp", type=int, default=4, help="samples per pixel")
    p.add_argument("--anim-frames", type=int, default=0,
                   help="render an animation of N camera positions; each "
                        "move resets progressive accumulation (the "
                        "file-sequence analog of the reference's "
                        "interactive loop, main.cpp:193-282)")
    p.add_argument("--orbit", type=float, default=0.0,
                   help="degrees to orbit around the look-at target per "
                        "animation frame")
    p.add_argument("--fly", type=float, default=0.0,
                   help="distance to fly forward per animation frame "
                        "(the WASD analog, main.cpp:253-266)")
    p.add_argument("--max-depth", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--wave-size", type=int, default=128 * 128 * 4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="out.png", help=".png or .pfm output")
    p.add_argument("--serve", type=int, default=0, metavar="PORT",
                   help="serve a LIVE interactive view on "
                        "http://127.0.0.1:PORT/ with WASD/mouse camera "
                        "controls (the reference's GLUT loop, "
                        "main.cpp:239-282, for a headless host)")
    p.add_argument("--preview-every", type=int, default=0,
                   help="re-write --out every K progressive samples — the "
                        "file-backed analog of the reference's per-frame "
                        "present (DisplayBuffer.cpp:106-132)")
    p.add_argument("--checkpoint", help="save/resume accumulation state here")
    p.add_argument("--profile", action="store_true",
                   help="measure per-stage timings (trace/shade/env) "
                        "after rendering and print the breakdown")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device to render on (default: the current "
                        "CUDA device; 'cpu' runs the kernels' plain "
                        "versions on the host)")
    return p


def select_backend(args) -> str:
    """Map the reference's engine flags onto a traversal backend
    (main.cpp:289-302): --no-gpu => lockstep xla, --no-cpu-tracing =>
    plain cluster engine mxu, default => pallas (the dense kernel)."""
    return args.backend or ("xla" if args.no_gpu
                            else ("mxu" if args.no_cpu else "pallas"))


def run(args):
    """Render as the parsed ``args`` say. Returns (renderer, RenderStats);
    the stats are None after ``--serve``."""
    import rayaccel_tpu_torch as racc
    from rayaccel_tpu_torch import rng
    from rayaccel_tpu_torch.scene import loader
    from rayaccel_tpu_torch.utils import image as img
    from rayaccel_tpu_torch.utils.stats import FrameTimer, RenderStats

    ctx = racc.create_context(racc.Configuration(
        backend=select_backend(args), wave_size=args.wave_size,
        hybrid_tracing=not args.no_hybrid), device=args.device)

    if args.scene:
        scene_data = loader.load_scene(args.scene)
    elif args.synthetic == "battlefield":
        scene_data = loader.make_battlefield_like()
    else:
        scene_data = loader.make_test_scene(viewport=(256, 192))

    if args.max_depth is not None:
        scene_data.max_depth = args.max_depth
    if args.width:
        scene_data.viewport_width = args.width
    if args.height:
        scene_data.viewport_height = args.height

    cam = racc.Camera.look_at(
        scene_data.cam_origin, scene_data.cam_dir, scene_data.cam_up,
        scene_data.cam_fov, scene_data.viewport_width,
        scene_data.viewport_height)

    cls = racc.WhittedRenderer if args.whitted else racc.PathTracingRenderer
    if args.whitted:
        scene_data.max_depth = 8  # main.cpp:346
    renderer = cls(ctx, cam, scene_data)

    base_key = rng.PRNGKey(args.seed)
    if args.checkpoint and os.path.exists(args.checkpoint + ".json"):
        from rayaccel_tpu_torch.utils.checkpoint import load_checkpoint
        # Continue the checkpointed key stream (ignoring --seed on resume)
        # so accumulation stays bit-exact across the boundary.
        stored_key = load_checkpoint(args.checkpoint, renderer)
        if stored_key is not None:
            base_key = stored_key
        if not args.quiet:
            print(f"resumed at spp={renderer.spp}")

    if args.serve:
        # Live loop (reference main.cpp:239-282): camera moves reset
        # progressive accumulation.
        from rayaccel_tpu_torch.utils.viewer import Viewer
        Viewer(renderer, base_key, scene_data.cam_up,
               port=args.serve).run(quiet=args.quiet)
        return renderer, None

    stats = RenderStats()

    def write(path):
        hdr = renderer.image()
        if path.endswith(".pfm"):
            img.write_pfm(path, hdr.astype(np.float32))
        else:
            img.write_png(path, img.tonemap(hdr, 1))

    def accumulate(frame_key):
        while renderer.spp < args.spp:
            key = rng.fold_in(frame_key, renderer.spp)
            with FrameTimer(stats, renderer) as ft:
                ft.run(key)
            if not args.quiet:
                print(stats.format_line())
            if (args.preview_every
                    and renderer.spp % args.preview_every == 0
                    and renderer.spp < args.spp):
                write(args.out)

    if args.anim_frames:
        # Scripted camera path: each move resets accumulation and renders
        # again to --spp, like the reference's interactive loop (spp reset
        # on move, main.cpp:204-205, 248-251).
        root, ext = os.path.splitext(args.out)
        target = np.asarray(scene_data.cam_dir, np.float32)
        up = np.asarray(scene_data.cam_up, np.float32)
        for f in range(args.anim_frames):
            if f:
                if args.orbit:
                    cam = cam.rotate(math.radians(args.orbit), up,
                                     pivot=target)
                if args.fly:
                    cam = dataclasses.replace(
                        cam, origin=(cam.origin
                                     + cam.forward() * args.fly).astype(
                                         np.float32))
                renderer.set_camera(cam)
            accumulate(rng.fold_in(base_key, 7000 + f))
            path = f"{root}_{f:04d}{ext}"
            write(path)
            if not args.quiet:
                print(f"frame {f}: wrote {path} ({renderer.spp} spp)")
        return renderer, stats

    accumulate(base_key)

    if args.checkpoint:
        from rayaccel_tpu_torch.utils.checkpoint import save_checkpoint
        save_checkpoint(args.checkpoint, renderer, base_key)

    write(args.out)
    if args.profile:
        from rayaccel_tpu_torch.utils.profiling import profile_stages
        stats.stages = profile_stages(renderer)
        print("stage breakdown:", stats.stages)
    if not args.quiet:
        s = stats.summary()
        print(f"wrote {args.out}: {renderer.spp} spp, "
              f"{s['rays_traced_total']/1e6:.1f}M rays, "
              f"{s['mrays_per_s_sliding']:.1f} Mrays/s")
    return renderer, stats


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.no_gpu and args.no_cpu:
        # The reference's conflicting-flag check (main.cpp:304-307).
        print("Conflicting arguments: --no-gpu and --no-cpu-tracing.",
              file=sys.stderr)
        return 1
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
