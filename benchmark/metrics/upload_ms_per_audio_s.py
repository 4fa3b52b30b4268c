"""Host milliseconds of the program's ``rvc.upload`` spans per second of
input audio over the main window's requests: packing the rows, the int16
quantization, the page-locking copy and the enqueued copies to the device
(``infer/pipeline.py``'s recorder, ``benchmark/program_spans.py``)."""

from benchmark.program_spans import ms_per_audio_s


def read(ctx):
    return ms_per_audio_s(ctx, ("rvc.upload",))
