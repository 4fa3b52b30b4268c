"""The share of the main window's f0 frames that kernel V decoded on the
card, in %: the program's ``viterbi_device_frames`` counter
(``ops/viterbi.py``, a decoded salience's frames) over its ``f0_frames``
(``CREPE.predict``'s and RMVPE's frames), both summed over the main
window's requests (``benchmark/program_spans.py``). Only the card's CREPE
decode counts V's frames, so where the process never counted them (the CPU,
a program without V) the metric is left out."""

from benchmark.program_spans import main_window

COUNTER = "viterbi_device_frames"


def read(ctx):
    from rvc_tpu_torch.utils import profiling

    if COUNTER not in profiling.counters():
        return None
    window = main_window(ctx)
    frames = sum(r["counters"].get("f0_frames", 0) for r in window or ())
    if not frames:
        return None
    return 100.0 * sum(r["counters"].get(COUNTER, 0) for r in window) / frames
