"""The share of the traced window's clock samples in which the card held
its clock down: the program's ``device.clock_limited`` (``hipe_tpu_torch/
profiling/trace.py``; NVML's current clock-event reasons, a sample limited
where the power cap, a thermal or a hardware slowdown is set; idle,
application clocks and display do not count). Nothing without the samples:
on the CPU, untraced, or a program that takes none."""

import program_spans


def read(r: dict):
    return program_spans.spans(r).get("device.clock_limited", {}).get("pct")
