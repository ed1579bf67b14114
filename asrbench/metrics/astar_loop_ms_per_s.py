"""astar_loop_ms_per_s: host milliseconds in `Engine._device_astar`
less its `prepare`: the A*'s set-up on the card, its rounds, captures,
read-back and the retry net, per second of audio."""


def read(run):
    if "astar" not in run.host_s:
        return None
    return run.ms_per_audio_s(run.host_s["astar"]
                              - run.host_s.get("prepare", 0.0))
