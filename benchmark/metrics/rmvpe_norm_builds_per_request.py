"""RMVPE's derived-weight rebuilds per request of the main window: the
program's ``rmvpe_norm_builds`` counter (``predictors/rmvpe.py``: each batch
norm's scale and shift, the BiGRU's stacked weights; 0 once set-up has built
them; ``benchmark/program_spans.py``). Set-up builds them in every program
that has the counter, so where the process never counted it the program
lacks it and the metric is left out."""

from benchmark.program_spans import per_request

COUNTER = "rmvpe_norm_builds"


def read(ctx):
    from rvc_tpu_torch.utils import profiling

    if COUNTER not in profiling.counters():
        return None
    return per_request(ctx, COUNTER)
