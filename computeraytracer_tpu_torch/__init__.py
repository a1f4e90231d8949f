"""computeraytracer_tpu_torch — the PyTorch/CUDA port of computeraytracer_tpu.

The JAX package beside it is the reference each module is checked
against; every module here keeps its counterpart's name. This package
imports torch and never jax. Tensors carry an explicit device: the CUDA
kernels run for tensors on the card, their plain torch versions for
tensors on the CPU.
"""

__version__ = "0.1.0"

from computeraytracer_tpu_torch.config import RenderConfig  # noqa: F401
from computeraytracer_tpu_torch.scene.data import (  # noqa: F401
    CameraSpec, Scene, SceneLights, ScenePrimitives, scene_from_jax)
from computeraytracer_tpu_torch.scene.loader import (  # noqa: F401
    load_scene, scene_from_dict)
