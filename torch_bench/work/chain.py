"""A pass of ``chain`` (K2: blur3, sharpen, edge fused): each byte of the
stream read once and written once; 13 + 12 + 28 = 53 integer operations an
output byte (gaussian 13; sharpen 5 multiply-adds and a clamp; edge two
gradients of 6 multiply-adds, two abs, an add and a min), over the int8
peak."""

PEAK = "int8_ops_per_s"


def bytes_moved(n: int, h: int, w: int, c: int) -> int:
    return 2 * n * h * w * c


def operations(n: int, h: int, w: int, c: int) -> int:
    return 53 * n * h * w * c
