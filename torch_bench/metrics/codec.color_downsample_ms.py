"""A transcode's RGB -> YCbCr, edge padding and downsampling (torch ops, every
chunk), a pass: the CUDA-event time of the ``codec.color_downsample`` spans
of ``ops/jpeg_encode.py``'s ``encode_planes`` (one a call, around all its
launches or chunks), summed over the traced window, over its passes. Nothing
without the spans' records or on the CPU."""

import program_spans


def read(r: dict):
    return program_spans.per_pass(r, "codec.color_downsample", "device_ms_total")
