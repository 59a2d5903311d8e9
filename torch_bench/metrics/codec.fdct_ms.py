"""A transcode's fDCTs and quantizers (K7, one launch a component), a pass:
the CUDA-event time of the ``codec.fdct`` spans of ``ops/jpeg_encode.py``'s
``encode_planes`` (one a call, around all its launches), summed over the
traced window, over its passes. Nothing without the spans' records or on
the CPU."""

import program_spans


def read(r: dict):
    return program_spans.per_pass(r, "codec.fdct", "device_ms_total")
