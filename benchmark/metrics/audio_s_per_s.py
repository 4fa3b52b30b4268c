"""Input audio seconds converted per second of the main serving window, by
the host's clock: every request of the window over all of its seconds. On
the short clips the host sets this rate and it spreads too widely from one
machine to the next for an end-to-end bound, so it stands here, beside the
latency tail that it moves."""


def read(ctx):
    if not ctx["window_s"] or not ctx["audio_s"]:
        return None
    return ctx["audio_s"] / ctx["window_s"]
