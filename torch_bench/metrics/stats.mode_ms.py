"""The mode filter, a pass: the CUDA-event time of the program's
``stats.mode`` spans (``ops/equalize.py``'s ``mode_planar``, one a chunk),
summed over the traced window, over its passes. Nothing without the spans'
records or on the CPU."""

import program_spans


def read(r: dict):
    return program_spans.per_pass(r, "stats.mode", "device_ms_total")
