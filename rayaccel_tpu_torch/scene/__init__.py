from rayaccel_tpu_torch.scene.clusters import (ClusterScene, compile_clusters,
                                               cluster_scene_from_numpy)
from rayaccel_tpu_torch.scene.compile import (TpuScene, compile_scene,
                                              create_scene,
                                              tpu_scene_from_numpy)
from rayaccel_tpu_torch.scene.data import SceneData
from rayaccel_tpu_torch.scene.loader import load_scene, save_scene

__all__ = ["ClusterScene", "SceneData", "TpuScene", "compile_clusters",
           "cluster_scene_from_numpy", "compile_scene", "create_scene",
           "tpu_scene_from_numpy", "load_scene", "save_scene"]
