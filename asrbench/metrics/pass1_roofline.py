"""pass1_roofline: the least time of pass 1 over each utterance's own
frames (the beam update's and the word-end stage's least bytes or
operations of the rows still inside their utterance at each frame,
asrbench/counts.py; padding is no work) over the device time of
everything launched in the pass-1 span, whatever kernels do the
work."""


def read(run):
    dev = run.device_s.get("pass1", 0.0)
    if dev <= 0 or run.least_s.get("pass1", 0.0) <= 0:
        return None
    return 100.0 * run.least_s["pass1"] / dev
