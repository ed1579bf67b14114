"""pass1_ms_per_s: host milliseconds in the pass-1 span
(`Engine._pass1`, synchronised at both ends) per second of audio."""


def read(run):
    return run.ms_per_audio_s(run.host_s.get("pass1", 0.0))
