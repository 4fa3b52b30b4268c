"""Host milliseconds of the program's ``rvc.dispatch`` spans per second of
input audio over the main window's requests: enqueuing the device graph
(mel, RMVPE, f0, HuBERT, retrieval, the synthesizer), with any copy inside
it that blocks on the device (``infer/pipeline.py``'s recorder,
``benchmark/program_spans.py``)."""

from benchmark.program_spans import ms_per_audio_s


def read(ctx):
    return ms_per_audio_s(ctx, ("rvc.dispatch",))
