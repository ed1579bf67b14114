"""DNN-HMM state scoring as a matmul chain (torch).

Port of `julius_tpu/ops/dnn.py`: hidden layers are logistic sigmoids;
the output is log10 softmax minus log10(state prior * factor) (reference
calc_dnn.c:852-868).  The products stay plain `torch.mm` calls, as the
reference package leaves them to XLA outside any kernel.

Precision follows the reference exactly: bfloat16 operands, float32
accumulation and a float32 result (JAX's `preferred_element_type`),
then the sigmoid output is rounded back to bfloat16 for the next layer.
A bf16 `torch.matmul` would instead round its result to bf16 before the
bias, the sigmoid and the logsumexp.  On CUDA `torch.mm(..., out_dtype=
torch.float32)` keeps the f32 result; the CPU has no such kernel, so
there the bf16 operands are widened to f32 (exact) and multiplied in
f32.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

INV_LOG_TEN = 1.0 / np.log(10.0)


def _param(a, dtype, device) -> nn.Parameter:
    # float32 first: exact for bf16 values, and numpy has no bf16 torch
    # can read
    t = torch.from_numpy(np.asarray(a, dtype=np.float32).copy())
    return nn.Parameter(t.to(device=device, dtype=dtype),
                        requires_grad=False)


class DNNScorer(nn.Module):
    """Senone scorer: [..., input_nodes] spliced features -> [..., n_out]
    log10 outprobs.  Weights are bf16, biases and the prior f32."""

    def __init__(self, weights: Sequence, biases: Sequence, output_w,
                 output_b, log_prior, device):
        super().__init__()
        bf16, f32 = torch.bfloat16, torch.float32
        self.weights = nn.ParameterList(
            [_param(w, bf16, device) for w in weights])
        self.biases = nn.ParameterList(
            [_param(b, f32, device) for b in biases])
        self.output_w = _param(output_w, bf16, device)
        self.output_b = _param(output_b, f32, device)
        self.log_prior = _param(log_prior, f32, device)

    @property
    def n_out(self) -> int:
        return self.output_w.shape[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dnn_scores(self, x)


def build_dnn_scorer(params, device) -> DNNScorer:
    """DNNScorer from host DNNParams (io/dnn.py)."""
    return DNNScorer(params.weights, params.biases, params.output_w,
                     params.output_b, params.log_prior, device)


def _mm_f32(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[n, a] bf16 @ [a, b] bf16 -> [n, b] f32 accumulated in f32."""
    if h.is_cuda:
        return torch.mm(h, w, out_dtype=torch.float32)
    return torch.mm(h.float(), w.float())


def dnn_scores(scorer: DNNScorer, x: torch.Tensor) -> torch.Tensor:
    """[..., input_nodes] spliced features -> [..., n_out] log10 outprobs
    (reference dnn_calc_outprob for a whole batch of frames at once)."""
    lead = x.shape[:-1]
    h = x.reshape(-1, x.shape[-1]).to(torch.bfloat16)
    for w, b in zip(scorer.weights, scorer.biases):
        h = torch.sigmoid(_mm_f32(h, w) + b).to(torch.bfloat16)
    out = _mm_f32(h, scorer.output_w) + scorer.output_b
    lse = torch.logsumexp(out, dim=-1, keepdim=True)
    res = INV_LOG_TEN * (out - lse) - scorer.log_prior
    return res.reshape(*lead, res.shape[-1])
