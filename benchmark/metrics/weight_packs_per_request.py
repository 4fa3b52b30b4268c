"""Packed-weight rebuilds per request of the main window: the program's
``weight_packs`` counter (``ops/resblock.py``'s ``WeightCache``; 0 once the
caches are warm; ``benchmark/program_spans.py``)."""

from benchmark.program_spans import per_request


def read(ctx):
    return per_request(ctx, "weight_packs")
