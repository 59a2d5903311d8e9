"""The mode filter's least time a pass (``work/mode5.py``: the stream's
bytes read once and written once over the memory's rate, which bound it)
over the device time a pass takes: the device's busy time in the traced
window, every kernel and copy the traced passes launched, over their
number, as ``pass_roofline`` reads it. Nothing without a trace, a bound or
a pass."""


def read(r: dict):
    t = r.get("trace")
    if not t or not r.get("bound_s_per_pass") or not t["passes"] or t["busy_s"] <= 0:
        return None
    return 100.0 * r["bound_s_per_pass"] * t["passes"] / t["busy_s"]
