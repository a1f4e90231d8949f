"""The mesh forward's share of its roofline in a render cell of a scene
with mesh parts past the kernels' shared tables, in percent: the least
time of the traced frames' trace work (``harness/roofline.py``, counted by
the reference, a mesh part at its traversal floor) over the device time of
the forward's global-table mesh build alone (``refill_fwd_wide_mesh``,
read from the trace's device ops by name). Nothing to read where the
trace names device ops and none of them is that build.

``harness/trace.py`` always names the device ops. A record without them
is read as all its device time only because the layout test
(``tests/test_bench_h100_layout.py``) hands every reader such a record
and asks each for a number."""

KERNEL = "refill_fwd_wide_mesh"


def read(rec):
    if rec["entry"] != "render":
        return None
    ops = rec.get("breakdown", {}).get("device_ops")
    if ops is None:
        kernel_s = rec["device_s"]
    else:
        kernel_s = sum(t for name, t in ops if KERNEL in name)
    if kernel_s <= 0:
        return None
    return 100.0 * rec["least_s"] * rec["units"] / kernel_s
