"""Host milliseconds of the program's ``rvc.download`` spans per second of
input audio over the main window's requests: the wait for the result, its
copy to the host and the int16 to float conversion (``infer/pipeline.py``'s
recorder, ``benchmark/program_spans.py``)."""

from benchmark.program_spans import ms_per_audio_s


def read(ctx):
    return ms_per_audio_s(ctx, ("rvc.download",))
