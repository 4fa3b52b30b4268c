"""Page-locked host allocations the program made per request of the main
window: its ``pinned_allocs`` counter (``infer/pipeline.py``, the upload's
``pin_memory`` and the stream's download buffer;
``benchmark/program_spans.py``)."""

from benchmark.program_spans import per_request


def read(ctx):
    return per_request(ctx, "pinned_allocs")
