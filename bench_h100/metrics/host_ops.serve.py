"""Host-issued torch ops per frame of a render cell: ``aten::`` ops with
no ``aten::`` parent in the traced frames (the API's and the kernel
tracer's per-sample Python)."""


def read(rec):
    if rec["entry"] != "render":
        return None
    return rec["host_ops"] / rec["units"]
