"""Configuration for the PyTorch/CUDA port.

Counterpart of ``rayaccel_tpu/config.py``: the same fields, defaults and
validation, so one configuration reads the same in both packages. The
port runs every engine, both samplers and the per-wave and frame-pooled
paths, on one device or, with ``mesh_shape=(D,)``, on the D ranks of a
``torch.distributed`` process group (``parallel/mesh.py``), at either
``precision`` (``"default"``: the bf16 tensor-core variants of the K1, K3
and K4 kernels) and with or without ``whitted_bounce_scan`` (the pooled
Whitted loop's dense bounces traced in slices).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Configuration:
    """Runtime configuration; field meanings as in ``rayaccel_tpu/config.py``.

    ``backend`` picks the engine that traces the primaries: "pallas" the
    dense work-queue engine (``ops/trace_dense.py``; the name is kept so
    that a configuration reads the same in both packages), "mxu" the plain
    cluster engine, "sparse" the pair engine, "xla" the lockstep BVH
    engine. "bruteforce" is the oracle of ``ops/trace.py:trace`` and runs
    no renderer.

    ``regroup`` takes the renderers' pooled frame (``render/pool.py``) on
    a cluster engine, and the per-wave body where it is off. The JAX
    package's wave functions also read it as a between-bounce coherence
    sort, which changes no radiance bit; the port has no such sort.
    """

    backend: str = "pallas"                 # "pallas" | "mxu" | "xla" | "sparse"
    hybrid_tracing: bool = True
    max_rays_in_flight: int = 128 * 128 * 16
    trace_block: int = 1024                 # on a card, a multiple of 64
    wave_size: int = 128 * 128 * 4
    traversal_stack_depth: int = 48
    sampler: str = "uniform"
    regroup: bool = True
    max_shading_depth: int = 8
    mesh_shape: Optional[Tuple[int, ...]] = None
    sparse_k_pairs: int = 4
    sparse_k_first: Optional[int] = None
    sparse_pair_budget: int = 3
    sparse_sp_tile: int = 1024
    sparse_max_passes: int = 4
    sparse_k_restart: Optional[int] = 8
    pallas_k_step: int = 4
    pallas_tile_cap: int = 256
    precision: str = "highest"
    reshard_bounces: bool = True
    min_stage_width: int = 8192
    whitted_stage_ratio: int = 2
    whitted_hot_levels: int = 3
    whitted_bounce_scan: Optional[int] = None

    def engine_opts(self) -> "EngineOpts":
        return EngineOpts(
            k_pairs=self.sparse_k_pairs,
            k_first=self.sparse_k_first,
            pair_budget=self.sparse_pair_budget,
            sp_tile=self.sparse_sp_tile,
            max_passes=self.sparse_max_passes,
            k_restart=self.sparse_k_restart,
            k_step=self.pallas_k_step,
            tile_cap=self.pallas_tile_cap,
            precision=self.precision,
        )

    def __post_init__(self):
        if self.backend not in ("mxu", "xla", "pallas", "sparse",
                                "bruteforce"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.sampler not in ("uniform", "stratified"):
            raise ValueError(f"unknown sampler {self.sampler!r}")
        if self.max_rays_in_flight <= 0 or self.wave_size <= 0:
            raise ValueError("ray counts must be positive")
        if self.wave_size % 8 != 0:
            raise ValueError("wave_size must be a multiple of 8")
        if not 1 <= self.sparse_k_pairs <= 8:
            raise ValueError("sparse_k_pairs must be in [1, 8]")
        if self.sparse_k_first is not None and not 1 <= self.sparse_k_first <= 8:
            raise ValueError("sparse_k_first must be None or in [1, 8]")
        if (self.sparse_k_restart is not None
                and not 1 <= self.sparse_k_restart <= 8):
            raise ValueError("sparse_k_restart must be None or in [1, 8]")
        if self.precision not in ("highest", "default"):
            raise ValueError(f"unknown precision {self.precision!r}")
        if (self.pallas_tile_cap < self.pallas_k_step
                or self.pallas_tile_cap % self.pallas_k_step != 0):
            raise ValueError("pallas_tile_cap must be a positive multiple "
                             "of pallas_k_step")
        if self.min_stage_width < 1024:
            raise ValueError("min_stage_width must be >= 1024")
        if self.whitted_stage_ratio < 2:
            raise ValueError("whitted_stage_ratio must be >= 2")
        if self.whitted_hot_levels < 1:
            raise ValueError("whitted_hot_levels must be >= 1")

    def pool_knobs(self) -> dict:
        """Frame-pool shape knobs for bench-line echoes."""
        return dict(min_stage_width=self.min_stage_width,
                    whitted_stage_ratio=self.whitted_stage_ratio,
                    whitted_hot_levels=self.whitted_hot_levels,
                    whitted_bounce_scan=self.whitted_bounce_scan,
                    max_shading_depth=self.max_shading_depth)


@dataclasses.dataclass(frozen=True)
class EngineOpts:
    """Tuning knobs threaded through the frame and trace functions.
    Defaults mirror Configuration's."""

    k_pairs: int = 4
    k_first: Optional[int] = None
    pair_budget: int = 3
    sp_tile: int = 1024
    max_passes: int = 4
    k_restart: Optional[int] = 8
    k_step: int = 4
    tile_cap: int = 256
    precision: str = "highest"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def dense_kwargs(self) -> dict:
        """The dense engine's knobs, as ``trace_dense`` and
        ``trace_occlusion_dense`` take them."""
        return dict(k_step=self.k_step, tile_cap=self.tile_cap,
                    precision=self.precision)

    def sparse_kwargs(self) -> dict:
        """The pair engine's knobs, as ``trace_occlusion_sparse`` takes
        them; the closest-hit ``trace_sparse`` also takes ``k_first``."""
        return dict(k_pairs=self.k_pairs, pair_budget=self.pair_budget,
                    sp_tile=self.sp_tile, max_passes=self.max_passes,
                    k_restart=self.k_restart, precision=self.precision)


@dataclasses.dataclass(frozen=True)
class ContextInfo:
    """Introspection data, as ``rayaccel_tpu/config.py:ContextInfo``."""

    device_count: int
    wave_size: int
    max_rays_in_flight: int
    backend: str


def default_configuration(backend: str = "pallas") -> Configuration:
    """The headline configuration: dense work-queue kernel for primaries,
    hybrid routing of bounces onto the sparse pair engine."""
    return Configuration(backend=backend)
