"""A transcode's filter and the stages after it (blur3: K1's rows entry), a
pass: the CUDA-event time of the ``codec.filter`` spans of
``runtime/serve.py``'s ``ServingPipeline.encode_fn`` (one a call, around all
its launches), summed over the traced window, over its passes. Nothing
without the spans' records or on the CPU."""

import program_spans


def read(r: dict):
    return program_spans.per_pass(r, "codec.filter", "device_ms_total")
