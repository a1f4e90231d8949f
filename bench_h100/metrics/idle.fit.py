"""The device's idle share over the traced steps of a fit cell:
1 - busy time (the union of the device's op intervals) / host wall."""


def read(rec):
    if rec["entry"] != "fit" or rec["busy_s"] <= 0:
        return None
    return 1.0 - rec["busy_s"] / rec["wall_s"]
