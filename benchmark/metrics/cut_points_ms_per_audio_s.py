"""Host milliseconds of the program's ``rvc.cut_points`` spans per second of
input audio over the main window's requests: ``Pipeline._find_cut_points``
(the 160-step moving sum and the quietest point near every 60 s), under
``rvc.prep`` (``infer/pipeline.py``; ``benchmark/program_spans.py``)."""

from benchmark.program_spans import ms_per_audio_s


def read(ctx):
    return ms_per_audio_s(ctx, ("rvc.cut_points",))
