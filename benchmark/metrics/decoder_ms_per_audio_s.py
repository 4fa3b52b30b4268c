"""Device milliseconds of the synthesizer's decoder (its stage tails included) per second of input audio, summed
over the main window's requests from CUDA events at the module's entry and
exit."""


def read(ctx):
    s, audio = ctx["spans_s"].get("decoder"), ctx["audio_s"]
    return 1e3 * s / audio if s and audio else None
