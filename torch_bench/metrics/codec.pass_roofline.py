"""A transcode's least time (``work/transcode.py``: the sets' bytes over the
memory's rate against libjpeg's operations over the int32 peak) over the
device time a pass takes: the device's busy time in the traced window,
every kernel and copy the traced passes launched, over their number, as
``pass_roofline`` reads it. Nothing without a trace, a bound or a pass."""


def read(r: dict):
    t = r.get("trace")
    if not t or not r.get("bound_s_per_pass") or not t["passes"] or t["busy_s"] <= 0:
        return None
    return 100.0 * r["bound_s_per_pass"] * t["passes"] / t["busy_s"]
