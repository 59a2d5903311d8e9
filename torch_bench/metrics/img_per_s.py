"""Images completed over the whole window, over the window's time (host
clock, the window closed by a synchronize)."""


def read(r: dict):
    return r["images"] / r["window_s"]
