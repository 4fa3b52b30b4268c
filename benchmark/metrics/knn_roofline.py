"""Retrieval's share of its roofline, in %: the least time for the calls
into ``ops/retrieval.py``'s ``knn_topk`` in the traced window (the
[frames, index rows] product at 495 TFLOP/s, f32; ``work/flops.py``), over
the device time of the kernels those calls launched."""


def read(ctx):
    dev = ctx["trace"]["scoped_device_s"].get("bench.knn")
    bound = ctx["bound_s"].get("bench.knn")
    return 100.0 * bound / dev if dev and bound else None
