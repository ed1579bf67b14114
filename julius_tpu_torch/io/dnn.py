"""DNN front-end definition loader (.dnnconf + npy weights + prior file).

Reference: Sample.dnnconf (key/value format), libsent/src/phmm/calc_dnn.c:528
(dnn_setup: npy '<f4' weight matrices W1..Wn, biases B1..Bn, output layer,
state priors in 'state_id prior' lines scaled by state_prior_factor).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from julius_tpu_torch.config import DNNConfig


@dataclass
class DNNParams:
    """Host-side DNN weights; see models/dnn.py for the device pytree."""

    weights: List[np.ndarray]   # hidden layers, each [in, out] (x @ W)
    biases: List[np.ndarray]    # [out]
    output_w: np.ndarray        # [hidden, n_out]
    output_b: np.ndarray        # [n_out]
    log_prior: np.ndarray       # [n_out] log10(prior * factor)
    context_len: int
    feature_len: int

    @property
    def input_nodes(self) -> int:
        return self.weights[0].shape[0]

    @property
    def output_nodes(self) -> int:
        return self.output_w.shape[1]


def parse_dnnconf(path: str) -> DNNConfig:
    cfg = DNNConfig(enabled=True)
    weights = {}
    biases = {}
    with open(path, "rt", encoding="utf-8") as f:
        for line in f:
            s = line.strip()
            if not s or s.startswith("#"):
                continue
            key, _, val = s.partition(" ")
            key = key.strip()
            val = val.strip()
            if key == "feature_type":
                cfg.feature_type = val
            elif key == "feature_len":
                cfg.feature_len = int(val)
            elif key == "context_len":
                cfg.context_len = int(val)
            elif key == "input_nodes":
                cfg.input_nodes = int(val)
            elif key == "output_nodes":
                cfg.output_nodes = int(val)
            elif key == "hidden_nodes":
                cfg.hidden_nodes = int(val)
            elif key == "hidden_layers":
                cfg.hidden_layers = int(val)
            elif key == "state_prior":
                cfg.state_prior_path = val
            elif key == "state_prior_factor":
                cfg.state_prior_factor = float(val)
            elif key == "batch_size":
                cfg.batch_size = int(val)
            elif key == "output_W":
                cfg.output_w = val
            elif key == "output_B":
                cfg.output_b = val
            elif key.startswith("W") and key[1:].isdigit():
                weights[int(key[1:])] = val
            elif key.startswith("B") and key[1:].isdigit():
                biases[int(key[1:])] = val
            # feature_options / num_threads / cuda_mode are host concerns
    cfg.weights = [weights[k] for k in sorted(weights)]
    cfg.biases = [biases[k] for k in sorted(biases)]
    return cfg


def _load_matrix(path: str, base: str) -> np.ndarray:
    p = path if os.path.isabs(path) else os.path.join(base, path)
    arr = np.load(p)
    if arr.dtype != np.float32:
        arr = arr.astype(np.float32)
    return arr


def load_prior(path: str, n_out: int, factor: float,
               log10nize: bool = True) -> np.ndarray:
    """'state_id prior' per line -> log10(prior * factor) array (reference
    calc_dnn.c:684-703; prior_factor_log10nize defaults TRUE, default.c:178).
    The DNN outprob scale in the reference is log10 (dnn_calc_outprob:
    INV_LOG_TEN * (x - logsumexp) - state_prior)."""
    prior = np.ones(n_out, dtype=np.float64)
    with open(path, "rt", encoding="utf-8") as f:
        for line in f:
            s = line.split()
            if len(s) >= 2:
                prior[int(s[0])] = float(s[1])
    prior = prior * factor
    if log10nize:
        prior = np.log10(np.maximum(prior, 1e-30))
    return prior.astype(np.float32)


def load_dnn(cfg: DNNConfig, base_dir: str = ".") -> DNNParams:
    weights = []
    biases = []
    for wp, bp in zip(cfg.weights, cfg.biases):
        W = _load_matrix(wp, base_dir)
        bvec = _load_matrix(bp, base_dir).reshape(-1)
        # reference stores W as [out, in] row-major for W·x
        # (calc_dnn.c:774); we keep [in, out] for x @ W on the MXU.
        if W.shape[0] == len(bvec) and W.shape[0] != W.shape[1]:
            W = W.T
        weights.append(np.ascontiguousarray(W))
        biases.append(bvec)
    out_w = _load_matrix(cfg.output_w, base_dir)
    out_b = _load_matrix(cfg.output_b, base_dir).reshape(-1)
    if out_w.shape[0] == len(out_b) and out_w.shape[0] != out_w.shape[1]:
        out_w = out_w.T
    n_out = out_w.shape[1]
    if cfg.state_prior_path:
        pp = cfg.state_prior_path
        if not os.path.isabs(pp):
            pp = os.path.join(base_dir, pp)
        log_prior = load_prior(pp, n_out, cfg.state_prior_factor)
    else:
        log_prior = np.zeros(n_out, dtype=np.float32)
    # sanity (reference dnn_setup checks topology consistency)
    if cfg.input_nodes and weights[0].shape[0] != cfg.input_nodes:
        raise ValueError(
            f"W1 input dim {weights[0].shape[0]} != input_nodes {cfg.input_nodes}")
    if cfg.output_nodes and n_out != cfg.output_nodes:
        raise ValueError(f"output dim {n_out} != output_nodes {cfg.output_nodes}")
    return DNNParams(
        weights=weights,
        biases=biases,
        output_w=np.ascontiguousarray(out_w),
        output_b=out_b,
        log_prior=log_prior,
        context_len=cfg.context_len,
        feature_len=cfg.feature_len or (
            cfg.input_nodes // max(1, cfg.context_len)),
    )
