"""Host milliseconds of the program's ``rvc.f0_net`` spans per second of
input audio over the main window's requests: the f0 network on the
windowed path (CREPE's framing, salience batches and the salience's copy to
the host; RMVPE's mel, forward and the wait for it), under ``rvc.host_f0``
(``predictors/crepe.py``, ``predictors/rmvpe.py``;
``benchmark/program_spans.py``)."""

from benchmark.program_spans import ms_per_audio_s


def read(ctx):
    return ms_per_audio_s(ctx, ("rvc.f0_net",))
