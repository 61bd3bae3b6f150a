"""The reference renderers: one path of the path tracer, or one Whitted ray
tree, for each (frame key, lane) asked for, in plain float32 PyTorch.

What the program derives from the scene and the configuration is worked
out again here from the raw inputs: the lane order of the frame (pixels in
32 x 16 blocks, waves of ``wave_size`` lanes), the camera's pixel deltas,
the probe's bilinear table and the random streams of each lane. The
semantics are the renderers' (``PathTracingRenderer``, ``WhittedRenderer``
and the reference demo's ``PathTracingRenderer.cpp`` /
``WhittedRenderer.cpp`` they port):

- Path tracer: camera jitter from ``fold_in(fold_in(key, w), 0)`` at the
  lane's place in wave w, or with the stratified sampler the R2 sequence
  at the frame's sample index, rotated per pixel by draws keyed from
  ``fold_in(PRNGKey(0x5EED), (y << 16) | x)``; the first BSDF draw from
  ``fold_in(fold_in(key, w), 1)`` at that place, bounce b (0 for the
  first bounce) from the lane's own stream ``fold_in(key, 4096 + b)``. A
  miss adds weight x probe; a path ends at ``max_depth`` hits, below the
  weight cut-off, or on a sample that leaves on the wrong side.
- Whitted: jitter from ``fold_in(key, w)``; each hit adds the grey
  material's direct light from the fixed light (zero where a shadow ray is
  blocked, with ``shadows``) and spawns a mirror and a refraction ray (none
  with ``primary_only``); a miss adds weight x probe.

Every node of a Whitted tree and every segment of a path is one traced ray,
and a shadow ray is one more: that is how the program counts
``rays_traced``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from rtbench.reference import geometry as geom
from rtbench.reference.rng import M32, lane_uniform, threefry2x32, uniform_at

WEIGHT_CUTOFF = 0.01
ORIGIN_EPSILON = 1e-4
SECONDARY_TMIN = 1e-3
SECONDARY_TMAX = 1e6
MATERIAL_GRAY = 0.3
LIGHT = np.float32((0.57, 0.57, 0.57))
LIGHT_UNIT = LIGHT / np.sqrt(np.float32(LIGHT[0] * LIGHT[0] + LIGHT[1] * LIGHT[1]
                                        + LIGHT[2] * LIGHT[2]))
ETA_GLASS = 1.1
BLOCK_W, BLOCK_H = 32, 16
BOUNCE_KEY_BASE = 4096
# The stratified sampler: jax.random.PRNGKey(0x5EED), the words (0, seed),
# and the plastic constant's R2 steps.
SAMPLER_KEY = (0, 0x5EED)
R2 = (0.7548776662466927, 0.5698402909980532)


class Scene(NamedTuple):
    geo: geom.Geometry
    camera: tuple          # (origin, view, right, up) float32 tensors
    env: torch.Tensor      # (H, W, 3)
    env_quad: torch.Tensor  # (H*W, 12)
    lane_x: torch.Tensor   # (n_lanes,) int64 pixel column of each lane
    lane_y: torch.Tensor
    lane_pixel: torch.Tensor  # (n_lanes,) flat pixel id, -1 for padding
    wave: int              # lanes a wave


def lane_order(width: int, height: int, wave: int):
    """(pixel, x, y) of every lane: pixels in 32 x 16 blocks, block-major,
    padded with -1 to whole waves."""
    nbx, nby = -(-width // BLOCK_W), -(-height // BLOCK_H)
    ys, xs = np.mgrid[0:nby * BLOCK_H, 0:nbx * BLOCK_W]
    key = (((ys // BLOCK_H) * nbx + (xs // BLOCK_W)) * (BLOCK_W * BLOCK_H)
           + (ys % BLOCK_H) * BLOCK_W + (xs % BLOCK_W))
    order = np.argsort(key.ravel(), kind="stable")
    xs, ys = xs.ravel()[order], ys.ravel()[order]
    n = -(-len(xs) // wave) * wave
    pixel = np.full(n, -1, np.int64)
    x = np.zeros(n, np.int64)
    y = np.zeros(n, np.int64)
    inside = (xs < width) & (ys < height)
    pixel[:len(xs)] = np.where(inside, ys * width + xs, -1)
    x[:len(xs)], y[:len(xs)] = xs, ys
    return pixel, x, y


def look_at(origin, target, up, fov_deg, width, height):
    """The camera's origin and its view, right and up pixel deltas."""
    origin = np.asarray(origin, np.float32)
    forward = np.asarray(target, np.float32) - origin
    forward = forward / np.linalg.norm(forward)
    right = np.cross(forward, np.asarray(up, np.float32))
    right = right / np.linalg.norm(right)
    cam_up = np.cross(right, forward)
    ext_y = math.tan(0.5 * fov_deg * (math.pi / 180.0))
    ext_x = ext_y * (float(width) / float(height))
    return (origin,
            (forward + right * ext_x + cam_up * ext_y).astype(np.float32),
            (right * (-2.0 / width * ext_x)).astype(np.float32),
            (cam_up * (-2.0 / height * ext_y)).astype(np.float32))


def build(scene: dict, wave: int, device) -> Scene:
    """The reference's view of a scene's arrays, for frames of lanes in
    waves of ``wave``."""
    w, h = scene["viewport_width"], scene["viewport_height"]
    cam = look_at(scene["cam_origin"], scene["cam_dir"], scene["cam_up"],
                  scene["cam_fov"], w, h)
    env = np.asarray(scene["env_pixels"], np.float32)[..., :3]
    eh, ew = env.shape[:2]
    xs, ys = np.arange(ew), np.arange(eh)
    x1, y1 = np.minimum(xs + 1, ew - 1), np.minimum(ys + 1, eh - 1)
    quad = np.concatenate([env[ys[:, None], xs[None, :]],
                           env[ys[:, None], x1[None, :]],
                           env[y1[:, None], xs[None, :]],
                           env[y1[:, None], x1[None, :]]],
                          axis=-1).reshape(eh * ew, 12)
    pixel, x, y = lane_order(w, h, wave)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return Scene(geo=geom.build(scene, device),
                 camera=tuple(t(a) for a in cam), env=t(env),
                 env_quad=t(quad), lane_x=t(x, torch.int64),
                 lane_y=t(y, torch.int64), lane_pixel=t(pixel, torch.int64),
                 wave=wave)


def environment(sc: Scene, d):
    """Bilinear clamp-to-edge lookup of the angular probe along ``d``."""
    h, w = sc.env.shape[:2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    len2 = dy * dy + dz * dz
    rlen = torch.where(len2 > 0, 1.0 / torch.sqrt(len2),
                       torch.full_like(len2, math.inf))
    acos = torch.acos(torch.clamp(-dx, -1.0, 1.0).double()).float()
    r = acos * (1.0 / (2.0 * np.pi)) * rlen
    r = torch.where(torch.isfinite(r) & (rlen <= 1e6), r, torch.zeros_like(r))
    fx = (0.5 - r * dz) * w - 0.5
    fy = (0.5 - r * dy) * h - 0.5
    x0, y0 = torch.floor(fx), torch.floor(fy)
    tx, ty = (fx - x0)[:, None], (fy - y0)[:, None]
    x0i = torch.clamp(x0.to(torch.int32), 0, w - 1)
    y0i = torch.clamp(y0.to(torch.int32), 0, h - 1)
    q = sc.env_quad[(y0i * w + x0i).long()]
    top = q[:, 0:3] * (1 - tx) + q[:, 3:6] * tx
    bot = q[:, 6:9] * (1 - tx) + q[:, 9:12] * tx
    return top * (1 - ty) + bot * ty


def keys_of(keys: torch.Tensor, data) -> torch.Tensor:
    """``fold_in`` of per-row keys (n, 2) int64 with ``data`` (an int or an
    (n,) tensor)."""
    zero = torch.zeros_like(keys[:, 0])
    data = torch.as_tensor(data, dtype=torch.int64, device=keys.device)
    k0, k1 = threefry2x32(keys[:, 0], keys[:, 1], zero,
                          (data + zero) & 0xFFFFFFFF)
    return torch.stack([k0, k1], dim=1)


def _uniform_rows(keys, index):
    """``uniform_at`` with one key a row."""
    return uniform_at((keys[:, 0], keys[:, 1]), index)


def _lane_uniform_rows(keys, lane):
    return lane_uniform((keys[:, 0], keys[:, 1]), lane)


def stratified_jitter(sc: Scene, lanes, spp):
    """The stratified sampler's sub-pixel offsets of ``lanes`` at sample
    indices ``spp`` (one a lane): a rotation drawn per pixel as
    ``uniform(fold_in(SAMPLER_KEY, (y << 16) | x), (2,))``, plus
    f32(spp) x f32(R2), modulo 1."""
    pix = (sc.lane_y[lanes] << 16) | sc.lane_x[lanes]
    k0, k1 = threefry2x32(*SAMPLER_KEY, torch.zeros_like(pix), pix & M32)
    s = spp.to(torch.float32)
    return tuple(
        torch.remainder(uniform_at((k0, k1), torch.full_like(pix, c))
                        + s * torch.tensor(R2[c], dtype=torch.float32,
                                           device=s.device), 1.0)
        for c in (0, 1))


def primary_rays(sc: Scene, jitter_keys, lanes, sampler: str = "uniform",
                 spp=None):
    """Camera rays of ``lanes`` with the jitter drawn from
    ``uniform(jitter_key, (2, wave))`` at the lane's place in its wave, or
    with ``sampler="stratified"`` the stratified sampler's at sample
    indices ``spp``."""
    if sampler == "stratified":
        jx, jy = stratified_jitter(sc, lanes, spp)
    elif sampler == "uniform":
        local = lanes % sc.wave
        jx = _uniform_rows(jitter_keys, local)
        jy = _uniform_rows(jitter_keys, sc.wave + local)
    else:
        raise ValueError(f"unknown sampler {sampler!r}")
    px = sc.lane_x[lanes].to(torch.float32) + jx
    py = sc.lane_y[lanes].to(torch.float32) + jy
    origin, view, right, up = sc.camera
    d = view[None, :] + right[None, :] * px[:, None] + up[None, :] * py[:, None]
    d = d * torch.rsqrt(geom.dot(d, d))[:, None]
    n = lanes.shape[0]
    return (origin[None, :].expand(n, 3).contiguous(), d,
            torch.zeros(n, device=d.device),
            torch.full((n,), 1e6, device=d.device))


class Surface(NamedTuple):
    pos: torch.Tensor
    ns: torch.Tensor       # shading normal, flipped toward the ray
    ng: torch.Tensor       # geometric normal, outward
    params: torch.Tensor   # (n, 4) material
    d_dot_ng: torch.Tensor
    entering: torch.Tensor


def surface(sc: Scene, o, d, hit: geom.TraceResult) -> Surface:
    g = sc.geo
    tri = hit.tri.clamp_min(0)
    u, v = hit.u[:, None], hit.v[:, None]
    n = g.normals[tri]
    ns = n[:, 0] * (1.0 - u - v) + n[:, 1] * u + n[:, 2] * v
    ns = ns * torch.rsqrt(torch.clamp_min(geom.dot(ns, ns), 1e-30))[:, None]
    ng = geom.cross(g.e1[tri], g.e2[tri])
    ng = ng * torch.rsqrt(torch.clamp_min(geom.dot(ng, ng), 1e-30))[:, None]
    d_dot_ng = geom.dot(d, ng)
    entering = d_dot_ng < 0
    return Surface(pos=o + hit.t[:, None] * d,
                   ns=torch.where(entering[:, None], ns, -ns), ng=ng,
                   params=g.materials[g.material[tri]], d_dot_ng=d_dot_ng,
                   entering=entering)


def _basis(n):
    nx, ny, nz = n[:, 0], n[:, 1], n[:, 2]
    zero = torch.zeros_like(nx)
    big_x = torch.abs(nx) > 0.1
    ux = torch.where(big_x, -nz, zero)
    uy = torch.where(big_x, zero, -nz)
    uz = torch.where(big_x, nx, ny)
    inv = torch.rsqrt(ux * ux + uy * uy + uz * uz)
    ux, uy, uz = ux * inv, uy * inv, uz * inv
    return (torch.stack([ux, uy, uz], dim=-1),
            torch.stack([ny * uz - nz * uy, nz * ux - nx * uz,
                         nx * uy - ny * ux], dim=-1))


def sample_bsdf(params, rnd, normal, wo):
    """The reflective-diffuse BSDF: a Fresnel mirror lobe and a cosine
    diffuse lobe, picked by weight. Returns (wi, colour)."""
    k, eta = params[:, 0:3], params[:, 3]
    cosi = torch.clamp_min(geom.dot(normal, wo), 0.0)
    refl = 2.0 * cosi[:, None] * normal - wo
    kk = eta * eta * (cosi * cosi - 1.0) + 1.0
    cost = torch.sqrt(torch.clamp_min(kk, 0.0))
    rper = (eta * cosi - cost) / (eta * cosi + cost)
    rpar = -((eta * cost - cosi) / (eta * cost + cosi))
    fresnel = 0.5 * (rpar * rpar + rper * rper)
    fresnel = torch.where(kk < 0.0, torch.ones_like(fresnel), fresnel)
    bu, bv = _basis(normal)
    phi = (2.0 * math.pi) * rnd[:, 0]
    sin_x = torch.sin(phi.double()).float()
    cos_x = torch.cos(phi.double()).float()
    r2s = torch.sqrt(rnd[:, 1])
    diff = (normal * torch.sqrt(1.0 - rnd[:, 1])[:, None]
            + (bu * cos_x[:, None] + bv * sin_x[:, None]) * r2s[:, None])
    diff = diff * torch.rsqrt(geom.dot(diff, diff))[:, None]
    s0 = fresnel * 3.0
    total = s0 + (k[:, 0] + k[:, 1] + k[:, 2])
    diffuse = rnd[:, 2] * total >= s0
    wi = torch.where(diffuse[:, None], diff, refl)
    color = torch.where(diffuse[:, None], k, fresnel[:, None])
    color = color * (total / (color[:, 0] + color[:, 1] + color[:, 2]))[:, None]
    return wi, color


def _finite(*vs):
    ok = None
    for v in vs:
        f = torch.isfinite(v).all(dim=-1)
        ok = f if ok is None else ok & f
    return ok


def path_trace(sc: Scene, keys, lanes, max_depth: int,
               sampler: str = "uniform", spp=None):
    """Radiance (n, 3) and rays traced (n,) of one path per (frame key,
    lane), the primaries jittered by ``sampler`` (``spp``: each row's
    sample index, for the stratified sampler)."""
    n = lanes.shape[0]
    dev = lanes.device
    wkeys = keys_of(keys, lanes // sc.wave)
    o, d, tmin, tmax = primary_rays(sc, keys_of(wkeys, 0), lanes, sampler,
                                    spp)
    local = lanes % sc.wave
    rnd0 = torch.stack([_uniform_rows(keys_of(wkeys, 1), 3 * local + c)
                        for c in range(3)], dim=1)
    weight = torch.ones((n, 3), device=dev)
    depth = torch.zeros(n, dtype=torch.int64, device=dev)
    rad = torch.zeros((n, 3), device=dev)
    rays = torch.zeros(n, dtype=torch.int64, device=dev)
    idx = torch.arange(n, device=dev)
    seg = 0
    while idx.numel():
        hit = geom.trace(sc.geo, o, d, tmin, tmax)
        rays[idx] += 1
        miss = hit.tri < 0
        rad[idx[miss]] = weight[miss] * environment(sc, d[miss])
        active = ~miss & (depth < max_depth)
        if seg == 0:
            rnd = rnd0[idx]
        else:
            rnd = _lane_uniform_rows(
                keys_of(keys[idx], BOUNCE_KEY_BASE + seg - 1), lanes[idx])
        s = surface(sc, o, d, hit)
        wi, color = sample_bsdf(s.params, rnd, s.ns, -d)
        new_w = weight * color
        wi_dot_ng = geom.dot(wi, s.ng)
        side_ok = (wi_dot_ng > 0) != (s.d_dot_ng > 0)
        pos = s.pos + s.ng * (ORIGIN_EPSILON * torch.where(
            wi_dot_ng >= 0, 1.0, -1.0))[:, None]
        ok = (torch.any(new_w > WEIGHT_CUTOFF, dim=-1) & side_ok
              & _finite(pos, wi))
        keep = active & ok
        idx, o, d, weight = idx[keep], pos[keep], wi[keep], new_w[keep]
        depth = depth[keep] + 1
        tmin = torch.full((idx.numel(),), SECONDARY_TMIN, device=dev)
        tmax = torch.full((idx.numel(),), SECONDARY_TMAX, device=dev)
        seg += 1
    return rad, rays


def whitted(sc: Scene, keys, lanes, max_depth: int, shadows: bool,
            primary_only: bool):
    """Radiance (n, 3) and rays traced (n,) of one Whitted tree per (frame
    key, lane), level by level."""
    n = lanes.shape[0]
    dev = lanes.device
    o, d, tmin, tmax = primary_rays(sc, keys_of(keys, lanes // sc.wave),
                                    lanes)
    light = torch.tensor(LIGHT.tolist(), device=dev)
    light_unit = torch.tensor(LIGHT_UNIT.tolist(), device=dev)
    weight = torch.ones((n, 3), device=dev)
    depth = torch.zeros(n, dtype=torch.int64, device=dev)
    rad = torch.zeros((n, 3), device=dev)
    rays = torch.zeros(n, dtype=torch.int64, device=dev)
    owner = torch.arange(n, device=dev)
    while owner.numel():
        hit = geom.trace(sc.geo, o, d, tmin, tmax)
        rays.index_add_(0, owner, torch.ones_like(owner))
        miss = hit.tri < 0
        rad.index_add_(0, owner[miss], weight[miss] * environment(sc, d[miss]))
        active = ~miss & (depth < max_depth)
        s = surface(sc, o, d, hit)
        new_w = weight * MATERIAL_GRAY
        direct = new_w * torch.clamp_min(geom.dot(s.ns, light[None, :]),
                                         0.0)[:, None]
        if shadows:
            sgn = torch.where(geom.dot(s.ng, light_unit[None, :]) >= 0,
                              ORIGIN_EPSILON, -ORIGIN_EPSILON)
            sa = active.nonzero().squeeze(1)
            so = (s.pos + s.ng * sgn[:, None])[sa]
            blocked = geom.trace(sc.geo, so, light_unit[None, :].expand_as(so),
                             torch.full((sa.numel(),), SECONDARY_TMIN,
                                        device=dev),
                             torch.full((sa.numel(),), SECONDARY_TMAX,
                                        device=dev)).tri >= 0
            rays.index_add_(0, owner[sa], torch.ones_like(sa))
            occluded = torch.zeros_like(active)
            occluded[sa] = blocked
            direct = torch.where(occluded[:, None], 0.0, direct)
        rad.index_add_(0, owner[active], direct[active])
        if primary_only:
            break
        cont = torch.any(new_w > WEIGHT_CUTOFF, dim=-1) & active
        ns = s.ns
        d_dot_n = geom.dot(d, ns)
        refl_d = d - (2.0 * d_dot_n)[:, None] * ns
        eta = torch.where(s.entering, 1.0 / ETA_GLASS, ETA_GLASS).to(
            torch.float32)
        r = 1.0 - eta * eta * (1.0 - d_dot_n * d_dot_n)
        mu = eta * d_dot_n + torch.sqrt(torch.clamp_min(r, 0.0))
        refr_d = eta[:, None] * d - mu[:, None] * ns
        d_side = s.d_dot_ng > 0
        kids = []
        for dir_new, extra, same_side in ((refl_d, None, False),
                                          (refr_d, r > 0.0, True)):
            dn = geom.dot(dir_new, s.ng)
            pos = s.pos + s.ng * torch.where(dn >= 0, ORIGIN_EPSILON,
                                             -ORIGIN_EPSILON)[:, None]
            ok = cont & _finite(pos, dir_new)
            if extra is not None:
                ok &= extra
            ok &= ((dn > 0) == d_side) if same_side else ((dn > 0) != d_side)
            kids.append((ok, pos, dir_new))
        owner = torch.cat([owner[k[0]] for k in kids])
        o = torch.cat([k[1][k[0]] for k in kids])
        d = torch.cat([k[2][k[0]] for k in kids])
        weight = torch.cat([new_w[k[0]] for k in kids])
        depth = torch.cat([depth[k[0]] + 1 for k in kids])
        tmin = torch.full((owner.numel(),), SECONDARY_TMIN, device=dev)
        tmax = torch.full((owner.numel(),), SECONDARY_TMAX, device=dev)
    return rad, rays
