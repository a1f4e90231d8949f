from computeraytracer_tpu_torch.bvh.builder import (BVHArrays, build_bvh,
                                                    scene_bvh, to_device)
from computeraytracer_tpu_torch.bvh.traverse import intersect_bvh

__all__ = ["BVHArrays", "build_bvh", "scene_bvh", "to_device",
           "intersect_bvh"]
