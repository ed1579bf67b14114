"""Carry the reference package's parameters and tables across.

The reference (`julius_tpu`) keeps its DNN scorer, decode-network tables
and hashed N-gram as dataclasses of arrays.  `numpy_fields` reads any
such dataclass into a dict of numpy arrays (np.asarray of each field,
lists kept as lists of arrays), and `load_tables` installs those arrays
in a port Engine, so both packages compute from the same numbers.  This
module reads the objects it is handed by field name and imports nothing
of the reference package.

bf16 weights arrive as numpy arrays of the `ml_dtypes.bfloat16` dtype,
which torch.from_numpy refuses: they go through float32, which holds
every bf16 value exactly (ops/dnn.py `_param`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from julius_tpu_torch.ops.dnn import DNNScorer
from julius_tpu_torch.search.ngram_device import (DeviceNgram,
                                                  device_ngram_from_numpy)
from julius_tpu_torch.search.pass1 import (DeviceNetwork,
                                           device_network_from_numpy)


def numpy_fields(obj) -> dict:
    """{field: value} of a dataclass of arrays: arrays become numpy
    arrays, lists lists of them, None and plain Python values stay."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, (list, tuple)):
            out[f.name] = [np.asarray(x) for x in v]
        elif v is None or isinstance(v, (bool, int, float, str)):
            out[f.name] = v
        else:
            out[f.name] = np.asarray(v)
    return out


def dnn_scorer(a: dict, device) -> DNNScorer:
    """DNNScorer from the reference scorer's fields (weights, biases,
    output_w, output_b, log_prior)."""
    return DNNScorer(a["weights"], a["biases"], a["output_w"],
                     a["output_b"], a["log_prior"], device)


def device_network(a: dict, device) -> DeviceNetwork:
    """DeviceNetwork from the reference network's fields.  Tables of
    configurations outside the port's pass 1 raise."""
    for name, item in (("cpair", "DFA"), ("rc_head", "head_rc_dynamic")):
        if a.get(name) is not None:
            raise NotImplementedError(
                f"{item} tables: ROADMAP.md queue 1, unfused pass1_step "
                "paths")
    return device_network_from_numpy(a, a["head_word"], a["tail_word"],
                                     a["local_k"], device)


def device_ngram(a: dict, device) -> DeviceNgram:
    """DeviceNgram from the reference hashed N-gram's fields."""
    return device_ngram_from_numpy(a["uni"], a["bo_uni"], a["bi_rows"],
                                   a["n_words"], a["bos_id"], a["eos_id"],
                                   a["unk_id"], a["wide"], device)


def load_tables(engine, dnn: dict, network: dict, ngram: dict) -> None:
    """Replace a port Engine's DNN scorer, network and N-gram tables
    with the given host arrays (each a `numpy_fields` dict)."""
    engine.dnn_scorer = dnn_scorer(dnn, engine.device)
    engine.dev_net = device_network(network, engine.device)
    engine.ngram_dev = device_ngram(ngram, engine.device)
