"""Device milliseconds of the HuBERT model's forward (content features) per second of input audio, summed
over the main window's requests from CUDA events at the module's entry and
exit."""


def read(ctx):
    s, audio = ctx["spans_s"].get("hubert"), ctx["audio_s"]
    return 1e3 * s / audio if s and audio else None
