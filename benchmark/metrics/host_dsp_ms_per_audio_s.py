"""Host milliseconds of the program's own signal processing per second of
input audio over the main window's requests: the self time of its
``rvc.prep`` spans (the index's copy to the device, the 48 Hz high-pass, the
cut-point search, the reflect pads) and ``rvc.finish`` spans (the trim, the
RMS envelope, the peak), from ``infer/pipeline.py``'s recorder
(``benchmark/program_spans.py``)."""

from benchmark.program_spans import ms_per_audio_s


def read(ctx):
    return ms_per_audio_s(ctx, ("rvc.prep", "rvc.finish"), self_time=True)
