"""CREPE's share of its roofline, in %: the least time the card could take
for the calls into the CREPE predictor's salience in the traced window
(a batch of frames each: operations at TF32's 495 TFLOP/s or bytes at
3.35 TB/s, whichever is longer; ``work/crepe_flops.py``), over the device
time of the kernels launched inside the program's ``rvc.crepe`` ranges."""


def read(ctx):
    dev = ctx["trace"]["scoped_device_s"].get("rvc.crepe")
    bound = ctx["bound_s"].get("rvc.crepe")
    return 100.0 * bound / dev if dev and bound else None
