"""The card's memory clock in the traced window: the median of the
program's samples (``hipe_tpu_torch/profiling/trace.py``'s
``device.mem_clock_mhz``, NVML's ``nvmlDeviceGetClockInfo`` every 10 ms
while the profiler records, up to the last span's end). Nothing without the
samples: on the CPU, untraced, or a program that takes none."""

import program_spans


def read(r: dict):
    return program_spans.spans(r).get("device.mem_clock_mhz", {}).get("median")
