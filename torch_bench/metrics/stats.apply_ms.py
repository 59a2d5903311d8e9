"""Equalize's LUT apply (the gather), a pass: the CUDA-event time of the program's ``stats.apply``
spans (``ops/equalize.py``'s ``equalize_planar``, one a chunk), summed over
the traced window, over its passes. Nothing without the spans' records or
on the CPU."""

import program_spans


def read(r: dict):
    return program_spans.per_pass(r, "stats.apply", "device_ms_total")
