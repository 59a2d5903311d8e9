"""The share of the traced window in which no kernel and no copy ran on
the device (``torch.profiler``'s device activity)."""


def read(r: dict):
    t = r.get("trace")
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
