"""The configuration's model inputs (asrbench/synth.py).

One deployment runs one model: the vocabulary, 2-gram, HMMs and DNN
weights come from the configuration's own `model_seed`, the same in
every run, and the run's seed draws only the traffic.  A model drawn
anew from each run's seed changed the work itself (how often the
program's retry net re-runs an utterance on the host), so runs of
different seeds differed by up to 2x where two runs of one seed agreed.
"""

from asrbench import synth


def build(cfg: dict, seed: int):
    return synth.build_model(cfg, int(cfg["model_seed"]))
