# No function re-exports here: `optimize` must stay importable as a
# submodule (computeraytracer_tpu_torch.train.optimize).
from computeraytracer_tpu_torch.train import checkpoint, optimize  # noqa: F401
