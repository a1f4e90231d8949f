"""Host-issued torch ops per step of a fit cell: ``aten::`` ops with no
``aten::`` parent in the traced steps (the training step, the kernel
tracer, the replay, autograd and Adam)."""


def read(rec):
    if rec["entry"] != "fit":
        return None
    return rec["host_ops"] / rec["units"]
