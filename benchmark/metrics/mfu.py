"""The whole conversion's share of the card's bf16 peak (989 TFLOP/s), in
%: the model operations of the main window's requests (HuBERT, RMVPE, the
synthesizer; ``work/flops.py``, each request at its real length with the
3 s pads) over the window's seconds."""


def read(ctx):
    if not ctx["window_s"] or not ctx["model_flops"]:
        return None
    return 100.0 * ctx["model_flops"] / ctx["window_s"] / ctx["peak_flops"]
