"""audio_s_per_s: seconds of audio whose poses reached the host, over
the whole measured window."""


def read(run):
    return run.window.work["audio_s"] / run.window.seconds
