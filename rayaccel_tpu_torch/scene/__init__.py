from rayaccel_tpu_torch.scene.clusters import (ClusterScene, compile_clusters,
                                               cluster_scene_from_numpy)
from rayaccel_tpu_torch.scene.data import SceneData

__all__ = ["ClusterScene", "SceneData", "compile_clusters",
           "cluster_scene_from_numpy"]
