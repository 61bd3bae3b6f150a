"""The comparison that decides ``correct``.

After the window, a sample drawn from the seed of the window's frames and
of the image's pixels is rendered again by the plain reference
(``rtbench/reference/``), from the same scene arrays and frame keys. What
the program produced for them was read during the window: the frame
buffer's rows of the sampled lanes after every frame, so that frame i's
radiance is the difference of two reads. The numbers compared:

- ``differ_pct``: the share of sampled (frame, pixel) radiances that
  differ from the reference's by more than ``RTOL`` x max(1, |ref|) in
  some channel. Two float32 intersection algebras pick different winners
  on shared edges, so a sound program differs on a few; a lower precision
  differs on many.
- ``rays_gap_pct``: how far the program's rays a frame (its
  ``rays_traced``) lie from the reference's count on the sampled pixels,
  scaled to the image.
- ``image_gap``: the largest difference between the program's image
  (``renderer.image()``) and its last frame buffer read over the frame
  count, at the sampled pixels: 0, as both are the same floats.
- ``dropped``: the rays the program dropped in the window: 0.

The harness adds ``metrics_unread``, the metrics due in the cell whose
readers found nothing to read (on a device other than CUDA, those read
from the device's trace are not due), and in a traced run
``layers_unseen``, the layers that a due metric names and whose entry
points the traced frames never called: 0 each.
"""

from __future__ import annotations

import numpy as np
import torch

from rtbench.reference import render

RTOL = 1e-3
FIXED_LIMITS = {"image_gap": 0.0, "dropped": 0}


def sample_lanes(seed: int, lane_pixel: np.ndarray, n: int) -> np.ndarray:
    """``n`` lanes of real pixels, drawn from the seed."""
    valid = np.nonzero(lane_pixel >= 0)[0]
    rng = np.random.default_rng([seed, 3])
    return np.sort(rng.choice(valid, size=min(n, len(valid)), replace=False))


def sample_frames(seed: int, n_frames: int, n: int) -> list:
    """``n`` of the window's frames, drawn from the seed, the last always
    among them."""
    rng = np.random.default_rng([seed, 4])
    pick = set(rng.choice(n_frames, size=min(n, n_frames),
                          replace=False).tolist())
    if n_frames - 1 not in pick:
        pick.discard(min(pick))
        pick.add(n_frames - 1)
    return sorted(pick)


def reference_samples(sc: render.Scene, integrator: str, params: dict,
                      frames, keys, lanes: np.ndarray, device):
    """The reference's radiance (F, P, 3) and rays (F, P) for each
    (window frame, lane): ``keys`` are the frames' keys, and a frame's
    index in the window is its sample index since the accumulation was
    cleared, which a ``sampler`` in ``params`` takes."""
    F, P = len(keys), len(lanes)
    k = torch.tensor(np.repeat(np.asarray(keys, np.int64), P, axis=0),
                     device=device)
    ln = torch.tensor(np.tile(lanes, F), dtype=torch.int64, device=device)
    if "sampler" in params:
        params = {**params, "spp": torch.tensor(
            np.repeat(np.asarray(frames, np.int64), P), device=device)}
    rad, rays = getattr(render, integrator)(sc, k, ln, **params)
    return (rad.reshape(F, P, 3).cpu().numpy(),
            rays.reshape(F, P).cpu().numpy())


def compare(port_rad: np.ndarray, ref_rad: np.ndarray,
            port_rays_per_frame: float, ref_rays: np.ndarray,
            n_pixels: int, image_gap: float, dropped: int,
            limits: dict) -> dict:
    """Each number beside its limit: {name: {"value", "limit"}}."""
    tol = RTOL * np.maximum(1.0, np.abs(ref_rad))
    # A radiance that is not a number differs.
    differ = ~(np.abs(port_rad - ref_rad) <= tol).all(axis=-1)
    ref_per_frame = float(ref_rays.mean()) * n_pixels
    values = {
        "differ_pct": 100.0 * float(differ.mean()),
        "rays_gap_pct": 100.0 * abs(port_rays_per_frame / ref_per_frame - 1),
        "image_gap": float(image_gap),
        "dropped": int(dropped),
    }
    all_limits = {**limits, **FIXED_LIMITS}
    return {k: {"value": v, "limit": all_limits[k]} for k, v in values.items()}


def passed(numbers: dict) -> bool:
    return all(n["value"] <= n["limit"] for n in numbers.values())
