"""Mesh construction and engine sharding, in one process (torch).

Port of `julius_tpu/parallel/mesh.py`.  The reference decoder has no
distributed execution; the mapping onto several devices is:

  * **dp** (data parallel): the utterance batch split over the mesh's
    rows, each row decoding its part on its own device;
  * **tp** (tensor parallel): the DNN feed-forward's hidden dimension
    split over a row's devices (the scaled-up analogue of the
    reference's OpenMP per-layer row split, calc_dnn.c:806-833).

The JAX package places arrays with named shardings and lets XLA insert
the collectives.  Here one process holds a copy of every table on each
device of the mesh, and each collective is an explicit tensor op on its
target device: a concatenation for an all-gather, a sum for a psum.  A
mesh may repeat a device (the same card, or the CPU, several times), so
one card or the CPU runs 2, 4 or 8 shards.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from julius_tpu_torch.ops.dnn import INV_LOG_TEN, DNNScorer, _mm_f32
from julius_tpu_torch.search import pass1 as p1
from julius_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ('dp', 'tp') grid of torch devices, devices[i][j]; a device may
    appear more than once."""

    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def dp(self) -> int:
        return len(self.devices)

    @property
    def tp(self) -> int:
        return len(self.devices[0])


def make_mesh(n_devices: Optional[int] = None, tp: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """('dp', 'tp') mesh over the first n of `devices` (default: every
    CUDA device; a list may repeat a device, as ["cuda:0"] * 4 does)."""
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    n = n_devices or len(devs)
    if n % tp != 0:
        raise ValueError(f"n_devices {n} not divisible by tp {tp}")
    if n > len(devs):
        raise ValueError(f"n_devices {n} but {len(devs)} devices given")
    return Mesh(tuple(tuple(devs[r * tp:(r + 1) * tp])
                      for r in range(n // tp)))


def replicate(x, device: torch.device):
    """A copy of `x` with every tensor inside it (dataclass fields,
    tuple items) on `device`; anything else is shared."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: replicate(getattr(x, f.name), device)
            for f in dataclasses.fields(x) if f.init})
    if isinstance(x, tuple):
        items = [replicate(a, device) for a in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def all_gather(parts: List[torch.Tensor], device: torch.device,
               dim: int = -1) -> torch.Tensor:
    """The parts' concatenation along `dim`, on `device`."""
    return torch.cat([p.to(device) for p in parts], dim=dim)


def psum(parts: List[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The parts' sum, in part order, on `device`."""
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


class TensorParallelDNN(nn.Module):
    """A DNNScorer split over one mesh row's devices, Megatron-style
    down the sigmoid chain:

      * even layers are column-split: each device holds W[:, cols] and
        b[cols], and its activation slice stays on it;
      * odd layers are row-split: each device multiplies its activation
        slice by W[rows, :], ONE psum gives the replicated activation,
        and the full bias is added after it.

    The output layer is the last hidden layer's partner: row-split (one
    psum) after a column-split layer, else column-split with one
    all-gather before the log-softmax.  So a chain of L hidden layers
    makes (L + 1) // 2 + 1 collectives at most; `collectives` counts
    them.  Inputs and outputs live on the row's first device."""

    def __init__(self, scorer: DNNScorer, devices: Sequence[torch.device]):
        super().__init__()
        self.devices = list(devices)
        tp = len(self.devices)
        self.collectives = 0
        ws, bs = [], []
        for i, (w, b) in enumerate(zip(scorer.weights, scorer.biases)):
            col = i % 2 == 0
            parts = torch.tensor_split(w, tp, dim=1 if col else 0)
            bparts = torch.tensor_split(b, tp) if col else [b] * tp
            ws.append([p.to(d) for p, d in zip(parts, self.devices)])
            bs.append([p.to(d) for p, d in zip(bparts, self.devices)])
        self.weights, self.biases = ws, bs
        self.output_row = len(ws) % 2 == 1
        self.output_w = [p.to(d) for p, d in zip(torch.tensor_split(
            scorer.output_w, tp, dim=0 if self.output_row else 1),
            self.devices)]
        head = self.devices[0]
        self.output_b = scorer.output_b.to(head)
        self.log_prior = scorer.log_prior.to(head)

    @property
    def n_out(self) -> int:
        return self.output_b.shape[0]

    def _psum_to_all(self, parts):
        self.collectives += 1
        return [psum(parts, d) for d in self.devices]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[..., input_nodes] -> [..., n_out] log10 outprobs, as
        ops.dnn.dnn_scores computes them."""
        lead = x.shape[:-1]
        h0 = x.reshape(-1, x.shape[-1]).to(torch.bfloat16)
        hs = [h0.to(d) for d in self.devices]
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            parts = [_mm_f32(h, wj) for h, wj in zip(hs, w)]
            if i % 2 == 1:
                parts = self._psum_to_all(parts)
            hs = [torch.sigmoid(p + bj).to(torch.bfloat16)
                  for p, bj in zip(parts, b)]
        parts = [_mm_f32(h, wj) for h, wj in zip(hs, self.output_w)]
        head = self.devices[0]
        self.collectives += 1
        out = (psum(parts, head) if self.output_row
               else all_gather(parts, head)) + self.output_b
        lse = torch.logsumexp(out, dim=-1, keepdim=True)
        res = INV_LOG_TEN * (out - lse) - self.log_prior
        return res.reshape(*lead, res.shape[-1])


#: the engine's device tables that a replica carries to its device
_TABLES = ("dev_net", "ngram_dev", "gmm_tables", "gms", "_state_sid",
           "_pseudo", "noise_spectrum")


def _replica(engine, device: torch.device):
    """A shallow copy of `engine` whose device tables live on `device`
    (what pass 1 and the scorers read; pass 2's lazy tables are
    rebuilt there on first use)."""
    rep = copy.copy(engine)
    rep.device = device
    for name in _TABLES:
        setattr(rep, name, replicate(getattr(engine, name), device))
    rep._device_chains = rep._iwcd2_tables = rep._chain_cache = None
    rep.align_graphs = None
    return rep


def shard_engine(engine, mesh: Mesh) -> None:
    """Place the engine's device tables onto the mesh, in place:
    `engine.mesh` and `engine.mesh_replicas`, one engine replica a mesh
    row on the row's first device.

    Search, N-gram and GMM tables are replicated (they are read-only
    gather targets); the DNN is tensor-split over the row's devices
    (`TensorParallelDNN`)."""
    replicas = []
    for row in mesh.devices:
        rep = _replica(engine, row[0])
        if engine.dnn_scorer is not None:
            rep.dnn_scorer = TensorParallelDNN(engine.dnn_scorer, row)
        replicas.append(rep)
    engine.mesh = mesh
    engine.mesh_replicas = replicas


def parallel_decode_fn(engine, mesh: Mesh):
    """Batched decode with the utterance batch split over dp.

    Returns fn(wave [B, L], lengths [B]) -> (Trellis [B, T, M],
    n_frames [B]) on the mesh's first device; B must be divisible by
    the dp axis size.  Each row runs the front end, its (tensor-split)
    scorer and the unfused pass 1, as the reference does here (its
    fused kernel cannot be partitioned), and the rows' trellises are
    concatenated.  The tables are placed by `shard_engine(engine,
    mesh)`, called here unless the engine is already on this mesh."""
    if getattr(engine, "mesh", None) is not mesh:
        shard_engine(engine, mesh)
    replicas = engine.mesh_replicas
    head = mesh.devices[0][0]

    def decode(wave, lengths):
        wave = torch.as_tensor(wave)
        lengths = torch.as_tensor(lengths)
        B = wave.shape[0]
        if B % mesh.dp != 0:
            raise ValueError(f"batch {B} not divisible by dp {mesh.dp}")
        b = B // mesh.dp
        parts, nfrs = [], []
        with torch.no_grad():
            for i, rep in enumerate(replicas):
                w = wave[i * b:(i + 1) * b].to(rep.device, torch.float32)
                n = lengths[i * b:(i + 1) * b].to(rep.device)
                feats, mask = rep._features(w, n)
                nfr = mask.to(torch.int32).sum(dim=-1)
                out_ext = rep._outprob(feats)
                parts.append(p1.pass1_batch(rep.dev_net, rep.ngram_dev,
                                            rep.p1_cfg, out_ext, nfr,
                                            use_kernel=False))
                nfrs.append(nfr)
        trellis = p1.Trellis(*[all_gather(list(f), head, dim=0)
                               for f in zip(*parts)])
        return trellis, all_gather(nfrs, head, dim=0)

    return decode
