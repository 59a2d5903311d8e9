"""Equalize's LUT build (``equalize_lut``), a pass: the CUDA-event time of the program's ``stats.lut``
spans (``ops/equalize.py``'s ``equalize_planar``, one a chunk), summed over
the traced window, over its passes. Nothing without the spans' records or
on the CPU."""

import program_spans


def read(r: dict):
    return program_spans.per_pass(r, "stats.lut", "device_ms_total")
