"""The yardstick's arithmetic: the card's published peaks, and the least
operations and bytes of each piece of work, from shapes and counts.

`step_bytes`, `step_ops`, `word_end_bytes`, `scan_bytes` and `scan_ops`
are frozen copies of the functions of the same names in the repository's
`chip_smoke.py`; the DNN's counts are the benchmark's own.  Each counts
what the work needs whatever implements it: every input byte read once
and every output byte written once.
"""

from __future__ import annotations

from typing import Sequence

#: NVIDIA H100 SXM, dense, at its 700 W power limit (NVIDIA's data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def least_s(flops_bf16: float = 0.0, flops_f32: float = 0.0,
            nbytes: float = 0.0) -> float:
    """The least time of a piece of work: the larger of its operations
    at the peak rate and its bytes at the peak bandwidth."""
    return max(flops_bf16 / PEAK_BF16_FLOPS + flops_f32 / PEAK_F32_FLOPS,
               nbytes / PEAK_HBM_BYTES)


def step_bytes(B, N, K1, R):
    """Least bytes one pass-1 frame must move: state read once and
    written once, the arc/entry/senone-map tables and the frame row read
    once."""
    state = B * N * (4 + 4 + 4)
    return 2 * state + K1 * N * 4 + N * 4 + N * 4 + B * R * 4 + B * 13


def step_ops(B, N, K1):
    """f32 operations of one pass-1 frame: per node K+1 arc adds, K
    compares, an entry add and compare, an emission add and compare."""
    return B * N * (2 * K1 + 3)


def word_end_bytes(B, Ex, k, M, lm, winner):
    """Least bytes of one word-end call: each row's exit scores and the
    exits' node ids and ln p once; for each of a row's k candidates its
    ctx and prev, its word, LM word, unigram and transparency, and with
    an LM its ctx_info row and the 8 probe rows of the 2-gram table (2
    words a row, 3 with wide keys); the [B, M] atoms written once, and
    the [B] winner and the frame index where asked."""
    probe = 0 if lm == 0 else 8 + 8 * 4 * (1 + lm)
    return (B * Ex * 4 + Ex * 12 + B * k * (8 + 13 + probe) + B * M * 24
            + (B * 12 + 4 if winner else 0))


def word_end_ops(B, Ex, k):
    """Operations of one word-end call: an add a gathered exit, and for
    each candidate 8 probe compares and about 6 correction ops."""
    return B * (Ex + 14 * k)


def scan_bytes(K, W, N, K1):
    """Least bytes of one windowed word scan: the gathered outprob and
    the seeds read once, the chains' tables and window starts read once,
    g / beg / sv written once."""
    return (K * W * N * 4 + K * W * 4 + K * (K1 + 3) * N * 4 + K * 8
            + 3 * K * W * 4)


def scan_ops(K, W, N, K1):
    """f32 operations of one scan: per node a frame K1 arc adds and K1-1
    compares, the entry add and compare, the emission compare and add,
    the word-end compare and add, and one argmax compare."""
    return K * W * N * (2 * K1 + 7)


def dnn_flops(frames: int, layers: Sequence[tuple]) -> float:
    """Multiply-adds (2 operations each) of `frames` frames through
    layers of (inputs, outputs)."""
    return 2.0 * frames * sum(a * b for a, b in layers)


def dnn_bytes(frames: int, layers: Sequence[tuple], d_in: int,
              r_out: int) -> float:
    """Least bytes of one scoring call: the bf16 weights and the f32
    biases once, each frame's f32 input read once and its r_out f32
    scores (senones and pseudo set-states) written once."""
    weights = sum(a * b * 2 + b * 4 for a, b in layers)
    return weights + frames * (d_in + r_out) * 4
