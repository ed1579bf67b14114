"""xrt: audio seconds of every utterance whose result came back in the
window, over the window's wall seconds (host clock)."""


def read(run):
    return run.audio_s / run.window_s if run.window_s > 0 else None
