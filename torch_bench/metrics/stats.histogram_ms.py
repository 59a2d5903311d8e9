"""Equalize's histogram stage (the int64 index and the ``scatter_add_``
counts), a pass: the CUDA-event time of the program's ``stats.histogram``
spans (``ops/equalize.py``'s ``equalize_planar``, one a chunk), summed over
the traced window, over its passes. Nothing without the spans' records or
on the CPU."""

import program_spans


def read(r: dict):
    return program_spans.per_pass(r, "stats.histogram", "device_ms_total")
