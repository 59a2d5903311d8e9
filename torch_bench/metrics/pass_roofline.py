"""A pass's least time (``work/<pipeline>.py``: its bytes over the memory's
rate against its operations over the peak) over the device time a pass
takes: the device's busy time in the traced window, every kernel and copy
the traced passes launched, over their number. Nothing without a trace, a
bound or a pass."""


def read(r: dict):
    t = r.get("trace")
    if not t or not r.get("bound_s_per_pass") or not t["passes"] or t["busy_s"] <= 0:
        return None
    return 100.0 * r["bound_s_per_pass"] * t["passes"] / t["busy_s"]
