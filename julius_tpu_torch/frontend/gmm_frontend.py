"""GMM front end: utterance verification, rejection, and GMM-VAD (torch).

Port of `julius_tpu/frontend/gmm_frontend.py` (reference
`libjulius/src/gmm.c`: gmm_init:429, per-frame gmm_proceed:574
accumulating frame log-likelihoods per model, gmm_end:657 taking the
best model to accept or reject via -gmmreject, and the GMM_VAD variant:
a sliding window of frame-wise voice/noise margins with up/down
triggers).

The GMM set is scored for all models x all frames in one call on the
front end's device (ops/gmm.py); the frame scores come to the host once,
where accumulation, the best model and the VAD margin are small numpy
reductions.  Each model contributes its best state per frame (the
reference's models are 1-state, where this is identical).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from julius_tpu_torch.models.hmm import HMMSet
from julius_tpu_torch.ops.gmm import build_gmm_tables, senone_scores
from julius_tpu_torch.utils.device import resolve_device
from julius_tpu_torch.utils.logadd import LOG_ZERO


@dataclass
class GMMResult:
    """Per-utterance verification outcome (reference gmm_end)."""

    best_name: str
    scores: dict                 # model name -> accumulated log-lh
    accepted: bool


class GMMFrontend:
    """Utterance verification GMM (-gmm / -gmmreject / -gmmnum), scored
    on `device` (CUDA unless the CPU is asked for)."""

    def __init__(self, hmm: HMMSet, reject_names: Sequence[str] = (),
                 vad_noise_names: Sequence[str] = (),
                 vad_margin: float = 0.7, vad_up: float = 2.0,
                 vad_down: float = -0.2, *, device="cuda"):
        self.device = resolve_device(device)
        self.hmm = hmm
        self.tables = build_gmm_tables(hmm, self.device)
        self.names = list(hmm.phone_names)
        self.reject = set(reject_names)
        # model m uses its states' senone rows
        P = hmm.n_phones
        S = hmm.n_states
        mask = np.full((P, S), False)
        for p in range(P):
            for j in range(int(hmm.phone_ns[p])):
                mask[p, int(hmm.phone_states[p, j])] = True
        self._mask = torch.as_tensor(mask, device=self.device)
        self._noise = np.asarray([n in set(vad_noise_names)
                                  for n in self.names], dtype=bool)
        self.vad_margin = vad_margin
        self.vad_up = vad_up
        self.vad_down = vad_down

    def frame_scores(self, feats) -> np.ndarray:
        """[T, D] -> [T, P] per-model frame log-likelihood on the host
        (max over the model's states; identical to the reference for
        1-state GMMs)."""
        x = torch.as_tensor(np.asarray(feats), dtype=torch.float32,
                            device=self.device)
        with torch.no_grad():
            s = senone_scores(self.tables, x)                    # [T, S]
            per_model = torch.where(self._mask[None], s[:, None, :],
                                    LOG_ZERO)
            return per_model.amax(dim=-1).cpu().numpy()          # [T, P]

    def verify(self, feats: np.ndarray,
               n_frames: Optional[int] = None) -> GMMResult:
        """Whole-utterance verification (gmm_proceed accumulation +
        gmm_end decision)."""
        fs = self.frame_scores(feats)
        if n_frames is not None:
            fs = fs[:n_frames]
        total = fs.sum(axis=0)
        best = int(np.argmax(total))
        name = self.names[best]
        return GMMResult(
            best_name=name,
            scores={n: float(t) for n, t in zip(self.names, total)},
            accepted=name not in self.reject,
        )

    def frame_margins(self, feats: np.ndarray) -> np.ndarray:
        """GMM_VAD frame scores: max(voice) - max(noise) per frame
        (reference gmm_proceed GMM_VAD block)."""
        fs = self.frame_scores(feats)
        noise = self._noise
        if not noise.any() or noise.all():
            return np.zeros(fs.shape[0], dtype=np.float32)
        vmax = fs[:, ~noise].max(axis=1)
        nmax = fs[:, noise].max(axis=1)
        return (vmax - nmax).astype(np.float32)

    def vad_decisions(self, feats: np.ndarray,
                      window: int = 5) -> np.ndarray:
        """Sliding-window up/down trigger over margins (reference
        GMM_VAD_SYNC margin averaging): True = speech."""
        m = self.frame_margins(feats)
        if len(m) == 0:
            return np.zeros(0, dtype=bool)
        kernel = np.ones(window) / window
        avg = np.convolve(m, kernel, mode="same")
        out = np.zeros(len(m), dtype=bool)
        in_sp = False
        for t in range(len(m)):
            if not in_sp and avg[t] > self.vad_up:
                in_sp = True
            elif in_sp and avg[t] < self.vad_down:
                in_sp = False
            out[t] = in_sp
        return out


def power_reject(feats: np.ndarray, veclen_power_idx: int,
                 thres: float) -> bool:
    """Average-power rejection (reference pass1.c:321 power_reject):
    True = reject.  Uses the absolute-energy coefficient."""
    if feats.shape[0] == 0:
        return True
    avg = float(np.mean(feats[:, veclen_power_idx]))
    return avg < thres
