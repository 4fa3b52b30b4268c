"""Device kernels launched in the traced serving window per second of input
audio converted there: the host's launch work per unit of service."""


def read(ctx):
    k, audio = ctx["trace"]["kernels"], ctx["trace_audio_s"]
    return k / audio if k and audio else None
