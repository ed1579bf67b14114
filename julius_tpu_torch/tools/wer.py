"""Word-error-rate scoring and accuracy evaluation harness.

The reference has no scoring tool (accuracy is eyeballed against the
README transcript, SURVEY.md §4); this provides the standard WER
computation (Levenshtein alignment with S/D/I breakdown) plus a
synthetic accuracy benchmark that decodes model-generated utterances at
a given noise level — the framework's accuracy regression gate.

    python -m julius_tpu_torch.tools.wer ref.txt hyp.txt
    python -m julius_tpu_torch.tools.wer --synthetic [noise]

Port of `julius_tpu/tools/wer.py`: the scoring is a copy; the synthetic
evaluation decodes with the port's Engine on the card
(`synthetic_eval(..., device="cpu")` and `main(argv, device="cpu")` on
the CPU).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import List, Sequence, Tuple


@dataclass
class WERResult:
    n_ref: int = 0
    n_sub: int = 0
    n_del: int = 0
    n_ins: int = 0
    n_sent: int = 0
    n_sent_err: int = 0

    @property
    def wer(self) -> float:
        return ((self.n_sub + self.n_del + self.n_ins)
                / max(1, self.n_ref))

    @property
    def ser(self) -> float:
        return self.n_sent_err / max(1, self.n_sent)

    def add(self, ref: Sequence[str], hyp: Sequence[str]):
        s, d, i = align_counts(ref, hyp)
        self.n_ref += len(ref)
        self.n_sub += s
        self.n_del += d
        self.n_ins += i
        self.n_sent += 1
        if s + d + i > 0:
            self.n_sent_err += 1

    def __str__(self):
        return (f"WER {100 * self.wer:.2f}% "
                f"[S={self.n_sub} D={self.n_del} I={self.n_ins} "
                f"N={self.n_ref}] SER {100 * self.ser:.2f}% "
                f"({self.n_sent_err}/{self.n_sent})")


def align_counts(ref: Sequence[str],
                 hyp: Sequence[str]) -> Tuple[int, int, int]:
    """(substitutions, deletions, insertions) via edit alignment."""
    R, H = len(ref), len(hyp)
    # dp[i][j] = (cost, s, d, i)
    INF = 1 << 30
    dp = [[(INF, 0, 0, 0)] * (H + 1) for _ in range(R + 1)]
    dp[0][0] = (0, 0, 0, 0)
    for j in range(1, H + 1):
        c = dp[0][j - 1]
        dp[0][j] = (c[0] + 1, c[1], c[2], c[3] + 1)
    for i in range(1, R + 1):
        c = dp[i - 1][0]
        dp[i][0] = (c[0] + 1, c[1], c[2] + 1, c[3])
        for j in range(1, H + 1):
            best = None
            # sub / match
            c = dp[i - 1][j - 1]
            cost = 0 if ref[i - 1] == hyp[j - 1] else 1
            best = (c[0] + cost, c[1] + cost, c[2], c[3])
            # del
            c = dp[i - 1][j]
            cand = (c[0] + 1, c[1], c[2] + 1, c[3])
            if cand[0] < best[0]:
                best = cand
            # ins
            c = dp[i][j - 1]
            cand = (c[0] + 1, c[1], c[2], c[3] + 1)
            if cand[0] < best[0]:
                best = cand
            dp[i][j] = best
    _, s, d, ins = dp[R][H]
    return s, d, ins


def score_files(ref_path: str, hyp_path: str) -> WERResult:
    """Line-aligned transcript files (optionally 'uttid text')."""
    res = WERResult()
    with open(ref_path) as rf, open(hyp_path) as hf:
        for ref, hyp in zip(rf, hf):
            res.add(ref.split(), hyp.split())
    return res


def synthetic_eval(noise: float = 1.0, n_utts: int = 30,
                   seed: int = 0, factoring: int = 1,
                   enable_pass2: bool = True,
                   device="cuda") -> WERResult:
    """Decode generative-model utterances with added observation noise
    and score against the generating transcript."""
    import io as _io
    import os

    import numpy as np

    # synthetic fixtures live beside the package in tests/ (numpy only)
    import julius_tpu_torch
    repo = os.path.dirname(os.path.dirname(
        os.path.abspath(julius_tpu_torch.__file__)))
    tests_dir = os.path.join(repo, "tests")
    if tests_dir not in sys.path:
        sys.path.insert(0, tests_dir)
    from fixtures import (make_arpa_text, make_dict_text,
                          make_hmmdefs_text, sample_states_and_frames)
    from julius_tpu_torch.config import SearchConfig
    from julius_tpu_torch.engine import Engine
    from julius_tpu_torch.io.arpa import parse_arpa
    from julius_tpu_torch.io.htk_dict import Vocabulary, parse_dict_line
    from julius_tpu_torch.io.htk_hmm import parse_hmmdefs_text

    hmm = parse_hmmdefs_text(make_hmmdefs_text(
        phones=("a", "b", "c", "sil"), dim=4, n_states=3, n_mix=2))
    voca = Vocabulary()
    for line in make_dict_text().splitlines():
        parse_dict_line(line, voca)
    lm = parse_arpa(_io.StringIO(make_arpa_text()))
    eng = Engine(hmm, voca, lm,
                 search=SearchConfig(lm_weight=2.0, factoring=factoring,
                                     enable_pass2=enable_pass2),
                 device=device)
    rng = np.random.default_rng(seed)
    name2id = {n: i for i, n in enumerate(voca.names)}
    content = [w for w in voca.names if w not in ("<s>", "</s>")]
    res = WERResult()
    for _ in range(n_utts):
        k = int(rng.integers(1, 4))
        words = ["<s>"] + [content[int(i)] for i in
                           rng.integers(0, len(content), k)] + ["</s>"]
        pids = [hmm.phone_index[p] for w in words
                for p in voca.phones[name2id[w]]]
        frames, _ = sample_states_and_frames(hmm, pids, rng)
        frames = frames + noise * rng.standard_normal(frames.shape) \
            .astype(np.float32)
        r = eng.decode_features(frames[None],
                                np.asarray([frames.shape[0]]))[0]
        hyp = r.words if r.valid else []
        res.add(words[1:-1], [w for w in hyp if w not in ("<s>", "</s>")])
    return res


def main(argv=None, device="cuda"):
    argv = argv if argv is not None else sys.argv[1:]
    if argv and argv[0] == "--synthetic":
        noise = float(argv[1]) if len(argv) > 1 else 1.0
        res = synthetic_eval(noise=noise, device=device)
        print(f"synthetic eval (noise={noise}): {res}")
        return 0
    if len(argv) != 2:
        print(__doc__)
        return 1
    print(score_files(argv[0], argv[1]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
