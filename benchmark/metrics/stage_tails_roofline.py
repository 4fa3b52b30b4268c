"""The stage tails' share of their roofline, in %: the least time the card
could take for the calls into ``ops/resblock.py``'s ``mrf_stage`` and
``resblock_chain`` in the traced window (operations at 989 TFLOP/s for bf16
input, 495 for the f32 chains; bytes at 3.35 TB/s; ``work/flops.py``),
over the device time of the kernels those calls launched."""


def read(ctx):
    dev = ctx["trace"]["scoped_device_s"].get("bench.stage_tails")
    bound = ctx["bound_s"].get("bench.stage_tails")
    return 100.0 * bound / dev if dev and bound else None
