"""Progressive-render checkpoint and resume.

Counterpart of ``rayaccel_tpu/utils/checkpoint.py``, in the same file
format, so that a checkpoint written by either package resumes in the
other: ``<base>.json`` holds the magic ``rayaccel_tpu-checkpoint-v1``, spp,
the viewport, ``n_lanes`` and the scene fingerprint; ``<base>.npz`` holds
``fb``, the accumulation buffer in block-swizzled lane order (the same
order in both packages), and ``key``, the base key's two uint32 words.
"""

from __future__ import annotations

import hashlib
import json

import numpy as np
import torch

_MAGIC = "rayaccel_tpu-checkpoint-v1"


def scene_fingerprint(renderer) -> str:
    """SHA-1 of the scene geometry and the camera pose, so that a
    checkpoint refuses to blend accumulation from another scene or
    viewpoint (the reference resets accumulation on any camera move,
    main.cpp:248-251). The bytes hashed are the JAX package's, so both give
    the same digest for the same scene and camera."""
    h = hashlib.sha1()
    sd = getattr(renderer, "scene_data", None)
    if sd is not None:
        h.update(np.asarray(sd.vertices, np.float32).tobytes())
        h.update(np.asarray(sd.indices, np.uint32).tobytes())
        h.update(np.asarray(sd.materials, np.float32).tobytes())
    cam = getattr(renderer, "camera", None)
    if cam is not None:
        for a in cam.as_arrays("cpu"):
            h.update(np.asarray(a.cpu().numpy(), np.float32).tobytes())
    return h.hexdigest()


def _base(path: str) -> str:
    return path[:-4] if path.endswith(".npz") else path


def save_checkpoint(path: str, renderer, base_key=None) -> None:
    """Write ``renderer``'s accumulation state, and the base :mod:`rng`
    key if given, to ``<path>.json`` and ``<path>.npz``."""
    meta = {
        "magic": _MAGIC,
        "spp": renderer.spp,
        "width": renderer.width,
        "height": renderer.height,
        "n_lanes": renderer.n_lanes,
        "fingerprint": scene_fingerprint(renderer),
    }
    base = _base(path)
    with open(base + ".json", "w") as f:
        json.dump(meta, f)
    arrays = {"fb": renderer.frame_buffer.cpu().numpy()}
    if base_key is not None:
        arrays["key"] = np.asarray(base_key, np.uint32)
    np.savez(base + ".npz", **arrays)


def load_checkpoint(path: str, renderer):
    """Restore accumulation state into ``renderer``. Returns the stored
    base key as an :mod:`rng` key (or None). ``path`` may be the base
    prefix or the .npz. Refuses another viewport, wave layout, scene or
    camera with the JAX package's messages."""
    base = _base(path)
    with open(base + ".json") as f:
        meta = json.load(f)
    if meta.get("magic") != _MAGIC:
        raise ValueError(f"{path}: not a rayaccel_tpu checkpoint")
    if (meta["width"], meta["height"]) != (renderer.width, renderer.height):
        raise ValueError(
            f"checkpoint viewport {meta['width']}x{meta['height']} != "
            f"renderer {renderer.width}x{renderer.height}")
    if meta["n_lanes"] != renderer.n_lanes:
        raise ValueError("wave layout mismatch (different wave_size?)")
    fp = meta.get("fingerprint")
    if fp is not None and fp != scene_fingerprint(renderer):
        raise ValueError(
            "checkpoint scene/camera fingerprint mismatch: refusing to "
            "blend accumulation across different scenes or viewpoints")
    with np.load(base + ".npz") as data:
        renderer.set_frame_buffer(torch.from_numpy(data["fb"]))
        key = (tuple(int(w) for w in data["key"]) if "key" in data
               else None)
    renderer.spp = int(meta["spp"])
    return key
