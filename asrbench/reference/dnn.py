"""Plain DNN senone scores.

The configuration's acoustic model: logistic sigmoid hidden layers, a
log10 softmax output less the log10 state prior (Julius's calc_dnn.c),
with bfloat16 operands, float32 products and float32 sums.  Here every
operand is rounded to its stated precision and multiplied as float32
with TF32 off, so the result is what the configuration states and not
what any kernel of the program does.  `operand="fp8"` rounds every
operand to float8 e4m3 with a per-tensor scale instead: the precision
below the stated one, which the benchmark's control runs.
"""

from __future__ import annotations

import math

import torch

FP8_MAX = 448.0


def _round(t: torch.Tensor, operand: str) -> torch.Tensor:
    if operand == "bf16":
        return t.to(torch.bfloat16).float()
    if operand == "fp8":
        scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
        return (t / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"unknown operand precision {operand!r}")


class PlainDNN:
    """The model's DNN with its operands rounded once, on `device`."""

    def __init__(self, model, device, operand: str = "bf16"):
        f32 = dict(dtype=torch.float32, device=device)
        self.operand = operand
        self.weights = [_round(torch.as_tensor(w, **f32), operand)
                        for w in model.weights]
        self.biases = [torch.as_tensor(b, **f32) for b in model.biases]
        self.out_w = _round(torch.as_tensor(model.out_w, **f32), operand)
        self.out_b = torch.as_tensor(model.out_b, **f32)
        self.log_prior = torch.as_tensor(model.log_prior, **f32)

    def __call__(self, x: torch.Tensor, block: int = 8192) -> torch.Tensor:
        """[n, D] spliced features -> [n, S] log10 senone scores."""
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            outs = []
            for r0 in range(0, x.shape[0], block):
                h = _round(x[r0:r0 + block].float(), self.operand)
                for w, b in zip(self.weights, self.biases):
                    h = _round(torch.sigmoid(h @ w + b), self.operand)
                o = h @ self.out_w + self.out_b
                o = (o - torch.logsumexp(o, dim=-1, keepdim=True)) \
                    / math.log(10.0)
                outs.append(o - self.log_prior)
            return torch.cat(outs) if outs else x.new_zeros(
                (0, self.out_w.shape[1]))
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved
