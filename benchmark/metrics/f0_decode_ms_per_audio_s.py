"""Host milliseconds of the program's ``rvc.f0_decode`` spans per second of
input audio over the main window's requests: the f0 decode on the windowed
path (CREPE's range mask, Viterbi over the bins and pitch read-out on the
host; RMVPE's ``decode_salience`` and the f0's copy to the host), under
``rvc.host_f0`` (``benchmark/program_spans.py``)."""

from benchmark.program_spans import ms_per_audio_s


def read(ctx):
    return ms_per_audio_s(ctx, ("rvc.f0_decode",))
