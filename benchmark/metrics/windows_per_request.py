"""Windows a request of the main window was cut into: the program's
``windows`` counter (``infer/pipeline.py``'s windowed path;
``benchmark/program_spans.py``). Every windowed request counts it, so where
the process never counted it the program lacks it and the metric is left
out."""

from benchmark.program_spans import per_request

COUNTER = "windows"


def read(ctx):
    from rvc_tpu_torch.utils import profiling

    if COUNTER not in profiling.counters():
        return None
    return per_request(ctx, COUNTER)
