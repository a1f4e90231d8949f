"""The kernels' share of their roofline in a fit cell, in percent: the
least time of the traced steps' trace work, forward and backward
(``harness/roofline.py``, counted by the reference) over the device time
of every kernel in them. Nothing to read without device time."""


def read(rec):
    if rec["entry"] != "fit" or rec["device_s"] <= 0:
        return None
    return 100.0 * rec["least_s"] * rec["units"] / rec["device_s"]
