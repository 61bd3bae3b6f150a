"""Multi-device tile parallelism: counterpart of ``rayaccel_tpu/parallel``,
one process per rank of a ``torch.distributed`` process group."""

from rayaccel_tpu_torch.parallel.mesh import (Mesh, make_mesh,
                                              replicate_scene,
                                              reshard_balance_cols,
                                              route_rows_home, sharded_wave)

__all__ = ["Mesh", "make_mesh", "sharded_wave", "reshard_balance_cols",
           "route_rows_home", "replicate_scene"]
