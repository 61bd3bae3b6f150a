"""Native (C++) host BVH builder: compiled on demand, bound with ctypes."""

from rayaccel_tpu_torch.scene.native.build import (build_bvh_native,
                                                   get_library,
                                                   native_available,
                                                   pair_leaves_native)

__all__ = ["build_bvh_native", "get_library", "native_available",
           "pair_leaves_native"]
