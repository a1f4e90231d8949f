"""Runtime checking (port of computeraytracer_tpu/utils/debug.py).

An opt-in sanitizer for the eager tracer and anything else written in
torch ops: every floating tensor that an op produces while the wrapped
function runs is checked for NaN (and, optionally, for +-inf), and the
backward passes it runs go under ``torch.autograd.detect_anomaly``, so a
NaN raises at the op that made it instead of silently corrupting the
image::

    from computeraytracer_tpu_torch.utils import debug
    img = debug.checked(lambda s: render_sample(s, 64, 64, 1))(scene)

Not for the hot path: every op reads its result back to test it (a
device synchronization per op on the card).
"""

from __future__ import annotations

import functools
import warnings

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


class CheckError(RuntimeError):
    """A NaN (or, with div=True, an infinity) was produced."""


class _FiniteCheck(TorchDispatchMode):
    """Raises CheckError when an op's floating output holds a NaN (and an
    infinity when inf is set)."""

    def __init__(self, inf: bool):
        super().__init__()
        self.inf = inf

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if not (isinstance(t, torch.Tensor) and t.is_floating_point()):
                continue
            if bool(torch.isnan(t).any()):
                raise CheckError(f"nan generated by {func}")
            if self.inf and bool(torch.isinf(t).any()):
                raise CheckError(f"inf generated by {func}")
        return out


def checked(fn, *, nan: bool = True, oob: bool = True, div: bool = False):
    """Wrap ``fn`` so that a NaN produced while it runs raises CheckError.

    nan: check every floating op output for NaN, and run any backward
    under ``torch.autograd.detect_anomaly`` (whose NaN error is raised as
    CheckError). div: also raise on +-inf. It is off by default because
    masked lanes legitimately hold infinities (a miss's distance is
    inf) that never reach a live value; a NaN made from them is still
    caught. oob is accepted for the JAX signature and costs nothing:
    torch already raises on out-of-bounds indexing (IndexError on the
    CPU, a device-side assert on the card)."""
    del oob

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not (nan or div):
            return fn(*args, **kwargs)
        try:
            with warnings.catch_warnings():
                warnings.filterwarnings(
                    "ignore", message="Anomaly Detection has been enabled")
                with torch.autograd.detect_anomaly(check_nan=nan), \
                        _FiniteCheck(inf=div):
                    return fn(*args, **kwargs)
        except CheckError:
            raise
        except RuntimeError as e:
            if "nan values" in str(e):
                raise CheckError(str(e)) from e
            raise

    return wrapper
