"""Share of the main serving window in which the device was idle, in %: one
less the device's busy seconds per model operation in the profiled window
(the union of kernel, copy and set intervals in ``torch.profiler``'s trace,
over the operations of its requests, ``work/flops.py``) times the main
window's operations per second. The profiler's host cost stretches the
profiled window but not the device's work per operation, so this is the
idle share of the window that is timed, with no profiler in it; and counting
operations rather than input seconds keeps the two windows' different mixes
of lengths and pads out of it."""


def read(ctx):
    t, ops = ctx["trace"], ctx["trace_model_flops"]
    if t["busy_s"] <= 0 or not ops or not ctx["window_s"] or not ctx["model_flops"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / ops * ctx["model_flops"] / ctx["window_s"])
