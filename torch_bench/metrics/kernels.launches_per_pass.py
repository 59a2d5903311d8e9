"""Launches a pass through the program's launch seam: the program's
``kernels.launches`` (``hipe_tpu_torch/profiling/trace.py``: the
``.launches`` of every ``ops/_build.py:entry`` wrapper, read at the profiler
session's first span and at its close) over the traced passes. Only the
hand-written kernels launch there: the torch ops of a path (the codec's
colour + downsample, say) are not counted. A session that counted no launch
has no entry, so a program that counts them reads 0 there, as on the CPU;
a program that does not count them, an untraced run, or records that are
not the traced window's read nothing."""

import program_spans


def read(r: dict):
    spans = program_spans.spans(r)
    if not spans:
        return None
    from hipe_tpu_torch.profiling import trace

    if not hasattr(trace, "LAUNCHES"):
        return None
    return spans.get(trace.LAUNCHES, {}).get("n", 0) / r["trace"]["passes"]
