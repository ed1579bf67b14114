"""astar_prepare_ms_per_s: host milliseconds in the device A*'s host
preparation (`search.pass2_device.prepare`) per second of audio; None
where pass 2 never ran."""


def read(run):
    if "prepare" not in run.host_s:
        return None
    return run.ms_per_audio_s(run.host_s["prepare"])
