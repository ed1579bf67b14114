"""Carry the reference package's parameters and tables across.

The reference (`julius_tpu`) keeps its DNN scorer, decode-network tables
and hashed N-gram as dataclasses of arrays, and its pass-2 chain tables
as an object with array attributes.  `numpy_fields` reads any such
dataclass into a dict of numpy arrays (np.asarray of each field, lists
kept as lists of arrays), `chain_fields` reads the chain tables,
`pseudo_fields` a triphone engine's pseudo set-state arrays,
`iwcd2_fields` its strict inter-word CD head tables, and `load_tables`
installs those arrays in a port Engine; `load_gmm_tables` and
`load_gms_tables` build the GMM scorer's tables from the reference's
(`numpy_fields` of its GMMScorerTables, `gms_fields` of its GMSTables),
so both packages compute from the same numbers.  This module reads the objects it is
handed by field or attribute name and imports nothing of the reference
package.

bf16 weights arrive as numpy arrays of the `ml_dtypes.bfloat16` dtype,
which torch.from_numpy refuses: they go through float32, which holds
every bf16 value exactly (ops/dnn.py `_param`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from julius_tpu_torch.ops import pseudo_kernel
from julius_tpu_torch.ops.dnn import DNNScorer
from julius_tpu_torch.ops.gmm import GMMScorerTables, gmm_tables_from_numpy
from julius_tpu_torch.ops.gms import GMSTables
from julius_tpu_torch.search.iwcd2 import StrictIWCDTables
from julius_tpu_torch.search.ngram_device import (DeviceNgram,
                                                  device_ngram_from_numpy)
from julius_tpu_torch.search.pass1 import (DeviceNetwork,
                                           device_network_from_numpy)
from julius_tpu_torch.search.scan import CHAIN_FIELDS, DeviceChainTables


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
    """DeviceNetwork from the reference network's fields (the DFA and
    per-context head tables included where the network has them)."""
    return device_network_from_numpy(a, a["head_word"], a["tail_word"],
                                     a["local_k"], a["rc_C"], device)


def device_ngram(a: dict, device) -> DeviceNgram:
    """DeviceNgram from the reference hashed N-gram's fields."""
    return device_ngram_from_numpy(a["uni"], a["bo_uni"], a["bi_rows"],
                                   a["n_words"], a["bos_id"], a["eos_id"],
                                   a["unk_id"], a["wide"], device)


def chain_fields(tabs) -> dict:
    """{name: value} of the reference's pass-2 chain tables
    (`device_chains`): the arrays loc, ent, ext, sidx as numpy arrays,
    and kl, nmax, n_words."""
    out = {name: np.asarray(getattr(tabs, name)) for name in CHAIN_FIELDS}
    out.update(kl=int(tabs.kl), nmax=int(tabs.nmax),
               n_words=int(tabs.n_words))
    return out


def device_chains(a: dict, device) -> DeviceChainTables:
    """DeviceChainTables from a `chain_fields` dict."""
    return DeviceChainTables.from_numpy(a, a["kl"], a["nmax"], a["n_words"],
                                        device)


def pseudo_fields(engine) -> Optional[dict]:
    """{members, segids, n_pseudo} of an engine's pseudo set-states (its
    `_pseudo` triple), or None for a network without them."""
    if engine._pseudo is None:
        return None
    members, segids, n_pseudo = engine._pseudo
    return dict(members=np.asarray(members), segids=np.asarray(segids),
                n_pseudo=int(n_pseudo))


def iwcd2_fields(tabs) -> dict:
    """{head_sidx, head_ns, lc_of_word, n_resolved} of strict inter-word
    CD head tables (`iwcd2_tables`)."""
    return dict(head_sidx=np.asarray(tabs.head_sidx),
                head_ns=np.asarray(tabs.head_ns),
                lc_of_word=np.asarray(tabs.lc_of_word),
                n_resolved=int(tabs.n_resolved))


def load_gmm_tables(a: dict, device) -> GMMScorerTables:
    """GMMScorerTables from the reference GMM scorer's fields (a,
    half_iv, c, state_mix, state_lw; the engine keeps the pseudo
    set-states itself, see `pseudo_fields`)."""
    return gmm_tables_from_numpy(a["a"], a["half_iv"], a["c"],
                                 a["state_mix"], a["state_lw"], device)


def gms_fields(gms) -> dict:
    """{gs, state2gs, gsnum} of the reference's GMS tables, the selector
    model's scorer tables as a `numpy_fields` dict."""
    return dict(gs=numpy_fields(gms.gs), state2gs=np.asarray(gms.state2gs),
                gsnum=int(gms.gsnum))


def load_gms_tables(a: dict, device) -> GMSTables:
    """GMSTables from a `gms_fields` dict."""
    return GMSTables(gs=load_gmm_tables(a["gs"], device),
                     state2gs=torch.as_tensor(
                         np.asarray(a["state2gs"], np.int64), device=device),
                     gsnum=a["gsnum"])


def load_tables(engine, dnn: dict, network: dict, ngram: dict,
                chains: Optional[dict] = None, pseudo: Optional[dict] = None,
                iwcd2: Optional[dict] = None) -> None:
    """Replace a port Engine's DNN scorer, network and N-gram tables
    with the given host arrays (each a `numpy_fields` dict), and, where
    given, its pass-2 chain tables (`chain_fields`), pseudo set-state
    arrays (`pseudo_fields`) and strict head tables (`iwcd2_fields`)."""
    engine.dnn_scorer = dnn_scorer(dnn, engine.device)
    engine.dev_net = device_network(network, engine.device)
    engine.ngram_dev = device_ngram(ngram, engine.device)
    if chains is not None:
        engine._device_chains = device_chains(chains, engine.device)
    if pseudo is not None:
        engine._pseudo = tuple(
            torch.as_tensor(pseudo[k], dtype=torch.int64,
                            device=engine.device)
            for k in ("members", "segids")) + (pseudo["n_pseudo"],)
        engine._pseudo_kernel = pseudo_kernel.tables_from_segments(
            *engine._pseudo, engine.device)
    if iwcd2 is not None:
        engine._iwcd2_tables = StrictIWCDTables.from_numpy(
            iwcd2["head_sidx"], iwcd2["head_ns"], iwcd2["lc_of_word"],
            iwcd2["n_resolved"], engine.device)
