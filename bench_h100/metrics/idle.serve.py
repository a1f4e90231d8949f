"""The device's idle share over the traced frames of a render cell:
1 - busy time (the union of the device's op intervals) / host wall."""


def read(rec):
    if rec["entry"] != "render" or rec["busy_s"] <= 0:
        return None
    return 1.0 - rec["busy_s"] / rec["wall_s"]
