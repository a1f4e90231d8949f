from computeraytracer_tpu_torch.scene.data import scene_from_jax  # noqa: F401
from computeraytracer_tpu_torch.scene.loader import (  # noqa: F401
    load_scene, scene_from_dict)
