"""A transcode's upsampling and YCbCr -> RGB (torch ops, every chunk), a pass:
the CUDA-event time of the ``codec.upsample_color`` spans of
``ops/jpeg_decode.py``'s ``decode_planes_scaled`` (one a call, around all
its launches or chunks), summed over the traced window, over its passes.
Nothing without the spans' records or on the CPU."""

import program_spans


def read(r: dict):
    return program_spans.per_pass(r, "codec.upsample_color", "device_ms_total")
