"""A transcode's IDCTs (K6, one launch a component), a pass: the CUDA-event
time of the ``codec.idct`` spans of ``ops/jpeg_decode.py``'s
``decode_planes_scaled`` (one a call, around all its launches), summed over
the traced window, over its passes. Nothing without the spans' records or
on the CPU."""

import program_spans


def read(r: dict):
    return program_spans.per_pass(r, "codec.idct", "device_ms_total")
