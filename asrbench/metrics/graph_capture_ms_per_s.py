"""graph_capture_ms_per_s: host milliseconds the CUDA graph caches
spent capturing in the window (pass 1's `DeviceNetwork.graphs` and the
A*'s `DeviceChainTables.graphs`, their `capture_s` counters read before
and after) per second of audio."""


def read(run):
    return run.ms_per_audio_s(run.capture_s)
