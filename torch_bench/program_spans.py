"""The program's own spans (``hipe_tpu_torch.profiling.trace``) after a
traced run, for the ``program_span`` metrics.

The program records a span only while a profiler records, and keeps its
records until it is told to forget them, so a reading stands only where the
``stream.pass`` records are as many as the traced window's passes: records
of another profiler session in the process, or past the program's bound,
give nothing. A reading is also ``None`` where there is nothing to read: a
checkout whose program has no such module, an untraced run, a span with no
record, or device time on the CPU.
"""

from __future__ import annotations

PASS = "stream.pass"


def spans(r: dict) -> dict:
    """The program's span summary by name for the readings ``r``, or ``{}``
    without the module, without a trace or where the passes disagree."""
    traced = (r.get("trace") or {}).get("passes")
    try:
        from hipe_tpu_torch.profiling import trace
    except ImportError:
        return {}
    s = trace.summary()
    if not traced or s.get(PASS, {}).get("n") != traced:
        return {}
    return s


def per_pass(r: dict, name: str, key: str):
    """``key`` of span ``name`` over the traced passes."""
    value = spans(r).get(name, {}).get(key)
    return None if value is None else value / r["trace"]["passes"]
