"""A pass of ``transcode`` at 4:2:0 (``c`` is 3): the coefficient sets read
once and written once, 128 B a block of 64 int16 (Y ceil(h/8) x ceil(w/8)
blocks, Cb and Cr ceil(h/16) x ceil(w/16) each); the pixels and sample grids
between the stages are not counted.

Operations, counted from libjpeg's C, each add, multiply, shift, mask,
compare, divide and table read as one (the int32 peak counts a multiply-add
as two), over the int32 rate of the CUDA cores:

- decode, a sample of a component's grid (K6): dequantize 1 (a multiply);
  jidctint.c's two 8-point passes, each 62 operations for 8 samples (even
  part 3 multiplies, 9 adds, 2 shifts; odd part 9 multiplies, 15 adds; the
  8 outputs an add and a descale of an add and a shift each), 15.5; the
  range limit, a mask and a table read, 2: 18.5;
- upsampling (jdsample.c h2v2_fancy), an output pixel of each chroma
  component: its share of a column sum 3a + b (2 a column, shared by 2
  outputs) 1, then 3 x sum + neighbour + bias and a shift 4: 5, so 10 a
  pixel;
- colour out (jdcolor.c), a pixel: R and B a table read, an add and a
  range-limit read (3 each); G two table reads, an add, a shift, an add
  and a range-limit read (6): 12;
- blur3 (K1's rows entry), 13 an output byte (``work/blur3.py``): 39 a
  pixel;
- colour in (jccolor.c), a pixel: Y, Cb and Cr 3 table reads, 2 adds and a
  shift each: 18;
- downsampling (jcsample.c h2v2), a chroma sample: 3 adds, the bias add,
  the shift and the bias flip: 6 (Y is copied);
- encode, a sample (K7): the level shift 1; jcfdctint.c's row pass 58
  operations for 8 samples (8 butterflies, 4 adds, DC and AC 4 an add and a
  shift each, the even rotation 2 + 2 x (multiply, add, descale), the odd
  part 4 adds, z5 2, 8 multiplies, 2 adds, 4 outputs of 2 adds and a
  descale), the column pass 60 (DC and AC 4 descaled: 3 each), 14.75; the
  quantizer (jcdctmgr.c) 6 a coefficient (sign test, negate, the half
  divisor's shift and add, the divide, the negate back): 21.75.

At 240x320 that is 142.375 operations a pixel.
"""

PEAK = "int32_ops_per_s"
# Decode and encode, a block of 64 samples: (18.5 + 21.75) x 64.
OPS_A_BLOCK = 2576
# Upsampling 10, colour out 12, blur3 39, colour in 18: a pixel.
OPS_A_PIXEL = 10 + 12 + 39 + 18
# Downsampling, a chroma sample of each of the two components.
OPS_A_CHROMA_SAMPLE = 6


def _blocks(h: int, w: int) -> int:
    """Blocks of a 4:2:0 set: Y and the two chroma components."""
    return -(-h // 8) * -(-w // 8) + 2 * -(-h // 16) * -(-w // 16)


def bytes_moved(n: int, h: int, w: int, c: int) -> int:
    return 2 * n * 128 * _blocks(h, w)


def operations(n: int, h: int, w: int, c: int) -> int:
    chroma = -(-h // 2) * -(-w // 2)
    return n * (OPS_A_BLOCK * _blocks(h, w) + OPS_A_PIXEL * h * w
                + 2 * OPS_A_CHROMA_SAMPLE * chroma)
