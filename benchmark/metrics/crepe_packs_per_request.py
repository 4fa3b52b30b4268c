"""CREPE's pack rebuilds per request of the main window: the program's
``crepe_packs`` counter (``predictors/crepe.py``: kernel C's packed weights
and folded batch norms, built once per weight version; 0 once set-up has
built them; ``benchmark/program_spans.py``). Only the card's path packs, so
where the process never counted it (the CPU, or a program without kernel
C) the metric is left out."""

from benchmark.program_spans import per_request

COUNTER = "crepe_packs"


def read(ctx):
    from rvc_tpu_torch.utils import profiling

    if COUNTER not in profiling.counters():
        return None
    return per_request(ctx, COUNTER)
