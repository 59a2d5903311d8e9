"""The host's own time a pass: the median host ms of the program's
``stream.pass`` span (``DeviceStreamRunner.run_passes``), enter to exit,
over the traced passes. Nothing without the span's records."""

import program_spans


def read(r: dict):
    return program_spans.spans(r).get(program_spans.PASS, {}).get("host_ms_median")
