"""dnn_ms_per_s: host milliseconds in the DNN-scoring span
(`Engine._outprob`, synchronised at both ends) per second of audio."""


def read(run):
    return run.ms_per_audio_s(run.host_s.get("dnn", 0.0))
