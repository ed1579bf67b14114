"""The system under test: the port's `Engine` built from a `Model`.

This is the only module of the benchmark that imports the port
(`julius_tpu_torch`).  It turns the plain model inputs of
`asrbench/synth.py` into the port's types, as the port's own builders
(`tools/synth.py` `flagship_engine`, `lvcsr_engine`) do, and builds one
`Engine` on the given device.
"""

from __future__ import annotations

import numpy as np


def build_engine(model, device: str, enable_pass2: bool = True):
    """The port's Engine over `model` (asrbench.synth.Model)."""
    from julius_tpu_torch.config import (AMConfig, SearchConfig,
                                         parse_feature_type)
    from julius_tpu_torch.engine import Engine
    from julius_tpu_torch.io.arpa import NGramLM
    from julius_tpu_torch.io.dnn import DNNParams
    from julius_tpu_torch.io.htk_dict import Vocabulary
    from julius_tpu_torch.models.hmm import HMMSet

    S = model.n_states
    hmm = HMMSet(
        means=model.means, ivars=model.ivars, gconst=model.gconst,
        state_mix=np.arange(S, dtype=np.int32).reshape(S, 1),
        state_lw=np.zeros((S, 1), np.float32),
        state_sid=np.arange(S, dtype=np.int32),
        phone_states=model.phone_states, phone_ns=model.phone_ns,
        phone_trans=model.phone_trans, phone_names=list(model.phone_names),
        phone_index=model.phone_index, logical_map=dict(model.logical_map),
        veclen=model.feat_dim, names_are_triphone=model.triphone)
    voca = Vocabulary()
    for i, (name, phones) in enumerate(zip(model.names, model.phones)):
        voca.add(name, phones, output="" if i < 2 else None)
    lm = NGramLM(order=2, words=list(model.names),
                 word_index={w: i for i, w in enumerate(model.names)},
                 ngrams=[{(w,): p for w, p in model.uni.items()},
                         {k: (p, 0.0) for k, p in model.bi.items()}],
                 bos_id=0, eos_id=1)
    dnn = DNNParams(weights=model.weights, biases=model.biases,
                    output_w=model.out_w, output_b=model.out_b,
                    log_prior=model.log_prior, context_len=model.context,
                    feature_len=model.feat_dim)
    s = model.search
    search = SearchConfig(lm_weight=s["lm_weight"], lm_penalty=s["lm_penalty"],
                          lm_weight2=s["lm_weight2"],
                          lm_penalty2=s["lm_penalty2"],
                          trellis_topm=s["trellis_topm"],
                          strict_iwcd2=s["strict_iwcd2"],
                          enable_pass2=enable_pass2)
    fe_cfg = parse_feature_type("FBANK_D_A")
    # static, delta and acceleration of each channel: only the sizes
    # matter, as the benchmark hands the engine its features
    fe_cfg.fbank_num = model.feat_dim // 3
    return Engine(hmm, voca, lm, dnn=dnn, frontend=fe_cfg, search=search,
                  am_cfg=AMConfig(iwcd_scheme=s["iwcd_scheme"]),
                  device=device)
