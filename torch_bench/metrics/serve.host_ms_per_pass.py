"""The host's own time a transcode: the median host ms of the program's
``serve.transcode`` span (the function ``ServingPipeline.transcode_fn``
returns, one a call), enter to exit, over the traced passes. Nothing
without the span's records."""

import program_spans


def read(r: dict):
    return program_spans.spans(r).get("serve.transcode", {}).get("host_ms_median")
