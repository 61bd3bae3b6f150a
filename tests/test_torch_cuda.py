"""Card-only checks of the port's hand-written kernels: each kernel, called
through its wrapper on CUDA tensors, against its plain version on the same
inputs, at test-scene size. A CUDA kernel has no CPU mode, so these skip
where no card is visible. On a machine with an NVIDIA Hopper GPU (no JAX
needed, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from rayaccel_tpu_torch.ops import trace_dense as dense
from rayaccel_tpu_torch.ops import trace_sparse as sparse
from rayaccel_tpu_torch.scene.clusters import (cluster_scene_from_numpy,
                                               compile_clusters_np)
from rayaccel_tpu_torch.scene.loader import make_battlefield_like
from rayaccel_tpu_torch.types import make_rays

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scenes(cuda):
    arrays = compile_clusters_np(make_battlefield_like(n_objects=40,
                                                       grid=21))
    return (cluster_scene_from_numpy(**arrays, device="cpu"),
            cluster_scene_from_numpy(**arrays, device=cuda))


def _rays(cs, n, seed, device):
    rs = np.random.default_rng(seed)
    lo, hi = cs.cl_bbmin.amin(0).numpy(), cs.cl_bbmax.amax(0).numpy()
    o = rs.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return make_rays(torch.tensor(o, device=device),
                     torch.tensor(d, device=device), tmin=0.0, tmax=1e6)


def _same_hits(a, b):
    """Hit masks agree on >= 99.95% of rays; t within 1e-3 relative on
    >= 99.95% of common hits (the oracle bar of tools/oracle_lib.py)."""
    ha, hb = a.tri.cpu() >= 0, b.tri.cpu() >= 0
    assert (ha == hb).float().mean() >= 0.9995
    both = ha & hb
    rel = (a.t.cpu() - b.t.cpu()).abs() / b.t.cpu().clamp_min(1e-6)
    assert (rel[both] < 1e-3).float().mean() >= 0.9995


def test_dense_kernel_matches_plain(cuda, scenes):
    cpu_cs, gpu_cs = scenes
    launches = dense.dense_closest_hit.launches
    got, ov = dense.trace_dense(gpu_cs, _rays(cpu_cs, 8192, 1, cuda),
                                tile=1024)
    want, ov_p = dense.trace_dense(cpu_cs, _rays(cpu_cs, 8192, 1, "cpu"),
                                   tile=1024)
    assert dense.dense_closest_hit.launches == launches + 1
    assert int(ov) == int(ov_p)
    _same_hits(got.hits, want.hits)


@pytest.mark.parametrize("k", [1, 4, 8])
def test_select_kernel_bitwise(cuda, scenes, k):
    cpu_cs, gpu_cs = scenes
    r = _rays(cpu_cs, 8192, k, "cpu")
    tmax = torch.where(torch.arange(8192) % 7 == 0, -1.0, r.tmax)
    tmax[:1024] = -1.0
    out = sparse._select(cpu_cs, r.o, 1 / r.d, r.tmin, tmax, k)
    prev = out[2]
    got = sparse._select(gpu_cs, r.o.to(cuda), (1 / r.d).to(cuda),
                         r.tmin.to(cuda), tmax.to(cuda), k, prev.to(cuda))
    want = sparse._select(cpu_cs, r.o, 1 / r.d, r.tmin, tmax, k, prev)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def test_pair_kernel_matches_plain(cuda, scenes):
    cpu_cs, gpu_cs = scenes
    got, ov = sparse.trace_sparse(gpu_cs, _rays(cpu_cs, 8192, 2, cuda))
    want, ov_p = sparse.trace_sparse(cpu_cs, _rays(cpu_cs, 8192, 2, "cpu"))
    assert sparse.pair_hit.launches > 0
    assert abs(int(ov) - int(ov_p)) <= 4
    _same_hits(got.hits, want.hits)


def _shadow_rays(cs, n, seed, device):
    """Rays over [1e-3, 20] with every fourth lane inactive."""
    r = _rays(cs, n, seed, device)
    r = r._replace(tmin=torch.full_like(r.tmin, 1e-3),
                   tmax=torch.full_like(r.tmax, 20.0))
    return r, torch.arange(n, device=device) % 4 != 3


def test_occlusion_kernel_matches_plain(cuda, scenes):
    """K4 through trace_occlusion_dense: one launch, the same overflow, and
    the same flags on >= 99.95% of rays (K4 and the plain version's matrix
    product may round the dot products differently at a triangle edge)."""
    cpu_cs, gpu_cs = scenes
    launches = dense.dense_occluded.launches
    r, active = _shadow_rays(cpu_cs, 8192, 3, cuda)
    got, ov = dense.trace_occlusion_dense(gpu_cs, r, active=active,
                                          tile=1024)
    r_c, active_c = _shadow_rays(cpu_cs, 8192, 3, "cpu")
    want, ov_p = dense.trace_occlusion_dense(cpu_cs, r_c, active=active_c,
                                             tile=1024)
    assert dense.dense_occluded.launches == launches + 1
    assert int(ov) == int(ov_p)
    assert (got.cpu() == want).float().mean() >= 0.9995
    assert want.any() and not got[~active].any()


def test_sparse_occlusion_on_card_matches_cpu(cuda, scenes):
    """trace_occlusion_sparse on the card (K2, and K3 with its tmax guard)
    against the same query on the CPU."""
    cpu_cs, gpu_cs = scenes
    launches = sparse.pair_hit.launches
    r, active = _shadow_rays(cpu_cs, 8192, 4, cuda)
    got, under = sparse.trace_occlusion_sparse(gpu_cs, r, active=active)
    r_c, active_c = _shadow_rays(cpu_cs, 8192, 4, "cpu")
    want, under_p = sparse.trace_occlusion_sparse(cpu_cs, r_c,
                                                  active=active_c)
    assert sparse.pair_hit.launches > launches
    assert abs(int(under) - int(under_p)) <= 4
    assert (got.cpu() == want).float().mean() >= 0.9995
    assert want.any()


def test_launch_validates_arguments(cuda, scenes):
    """A CUDA launch checks its arguments and raises; it never falls back
    to the plain version."""
    _, gpu_cs = scenes
    with pytest.raises(ValueError, match="items"):
        sparse.pair_hit(torch.zeros((4, 16), device=cuda), gpu_cs.G3,
                        torch.zeros((1, 3), dtype=torch.int64, device=cuda),
                        7, False)
