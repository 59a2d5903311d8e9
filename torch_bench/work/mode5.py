"""A pass of ``mode5`` (PIL ``ModeFilter(5)``): each byte of the stream read
once and written once; 10 integer operations a pixel, the floor that any
method counting a 5x5 window pays as the window slides (a sliding
histogram's 5 values in and 5 out), over the int32 rate of the CUDA cores.
Pillow's brute force (about 537 a pixel) and the port's pairwise form (770)
are what those methods spend, not what the filter needs, so the bytes set
the bound."""

PEAK = "int32_ops_per_s"


def bytes_moved(n: int, h: int, w: int, c: int) -> int:
    return 2 * n * h * w * c


def operations(n: int, h: int, w: int, c: int) -> int:
    return 10 * n * h * w * c
