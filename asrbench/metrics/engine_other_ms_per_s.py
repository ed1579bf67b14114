"""engine_other_ms_per_s: host milliseconds of `decode_features` less
its DNN, pass-1 and A* spans (the features' copy to the card, the
trellis to the host, lattices, the pass-1 fallback and the results'
assembly) per second of audio."""


def read(run):
    if "decode" not in run.host_s:
        return None
    rest = run.host_s["decode"] - sum(run.host_s.get(k, 0.0)
                                      for k in ("dnn", "pass1", "astar"))
    return run.ms_per_audio_s(rest)
