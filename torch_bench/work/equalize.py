"""A pass of ``equalize``: the stream read once for the histograms, then
read and written once through the tables (a 256-entry table a plane stays
in cache); two integer operations a byte (a histogram add and a table
lookup), over the int32 rate of the CUDA cores."""

PEAK = "int32_ops_per_s"


def bytes_moved(n: int, h: int, w: int, c: int) -> int:
    return 3 * n * h * w * c


def operations(n: int, h: int, w: int, c: int) -> int:
    return 2 * n * h * w * c
