from computeraytracer_tpu_torch.utils.image import read_png, write_png  # noqa: F401
from computeraytracer_tpu_torch.utils.metrics import RenderMeter  # noqa: F401
