"""A pass of ``blur3`` (K1): each byte of the stream read once and written
once; 13 integer operations an output byte (2(2r+1) multiply-adds, each
counted as two as the card's peak counts them, and a shift), over the int8
peak."""

PEAK = "int8_ops_per_s"


def bytes_moved(n: int, h: int, w: int, c: int) -> int:
    return 2 * n * h * w * c


def operations(n: int, h: int, w: int, c: int) -> int:
    return 13 * n * h * w * c
