"""dnn_roofline: the DNN's least time (its FLOPs over the valid
frames at the bf16 peak, or its weights', inputs' and scores' bytes at
the HBM peak, the larger; asrbench/counts.py) over the device time of
everything launched in the DNN span."""


def read(run):
    dev = run.device_s.get("dnn", 0.0)
    if dev <= 0 or run.least_s.get("dnn", 0.0) <= 0:
        return None
    return 100.0 * run.least_s["dnn"] / dev
