"""The port on the card: each CUDA kernel against its plain PyTorch
version, and the decode on CUDA against the decode on the CPU.

Every test here needs an NVIDIA card and skips without one.  The file
imports neither JAX nor the reference package, so it also runs where
JAX is not installed:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from julius_tpu_torch.ops import pass1_kernel as tpk
from julius_tpu_torch.search import pass1 as tp1
from julius_tpu_torch.tools import synth

from torch_fixtures import assert_same_step, make_step_inputs, run_step

pytestmark = pytest.mark.cuda

SMALL = dict(n_words=120, n_phones=48, hidden=128, n_layers=2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("B,K,N", [(1, 1, 5000), (64, 1, 5000),
                                   (3, 3, 4099), (2, 8, 300)])
def test_kernel_matches_plain(cuda, B, K, N):
    d = make_step_inputs(B + K, B, N, K)
    for f in range(3):
        before = tpk.LAUNCHES
        got = run_step(d, cuda, tpk.fused_step)
        torch.cuda.synchronize()
        assert tpk.LAUNCHES == before + 1
        want = run_step(d, cuda, tpk.fused_step_plain)
        assert_same_step(got, want)
        assert_same_step(got, run_step(d))            # and the CPU path
        d = dict(d, score=got[0], ctx=got[1], prev=got[2],
                 fv=np.roll(d["fv"], 1))


def test_kernel_rejects_bad_arguments(cuda):
    d = make_step_inputs(0, 2, 600, 1)
    t = {k: torch.tensor(v, device=cuda) for k, v in d.items()}
    args = [t[k] for k in ("score", "ctx", "prev", "loc", "et", "row",
                           "sidx", "ent", "ectx", "eprev", "fv")]
    bad = list(args)
    bad[1] = bad[1].long()
    with pytest.raises(TypeError, match="ctx"):
        tpk.fused_step(*bad)
    bad = list(args)
    bad[6] = bad[6].cpu()
    with pytest.raises(ValueError, match="score_idx"):
        tpk.fused_step(*bad)


@pytest.fixture(scope="module")
def engines():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    eng, protos = synth.flagship_engine(trained=True, device="cuda", **SMALL)
    cpu, _ = synth.flagship_engine(trained=True, device="cpu", **SMALL)
    truths, wins, lens = synth.make_flagship_utts(
        eng.hmm, eng.voca, eng.lm, protos, 3, 120, 11, min_words=2,
        max_words=5, seed=1)
    feats = np.zeros((3, max(lens), 1320), np.float32)
    for u, w in enumerate(wins):
        feats[u, :w.shape[0]] = w
    return eng, cpu, feats, np.asarray(lens, np.int32)


def test_pass1_kernel_path_matches_plain_path(engines, monkeypatch):
    eng, _, feats, lens = engines
    out = eng._outprob(torch.from_numpy(feats).cuda())
    before = tpk.LAUNCHES
    got = eng._pass1(out, lens)
    torch.cuda.synchronize()
    assert tpk.LAUNCHES == before + feats.shape[1]
    monkeypatch.setattr(tpk, "fused_step", tpk.fused_step_plain)
    want = eng._pass1(out, lens)
    assert torch.equal(got.word, want.word)
    valid = want.word >= 0
    for name in tp1.Trellis._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert torch.equal(torch.where(valid, a, 0), torch.where(valid, b, 0))


def test_decode_on_card_matches_cpu(engines):
    eng, cpu, feats, lens = engines
    got = eng.decode_features(feats, lens)
    want = cpu.decode_features(feats, lens)
    assert [r.word_ids for r in got] == [r.word_ids for r in want]
    assert [r.from_pass for r in got] == [r.from_pass for r in want]
    for g, w in zip(got, want):
        assert g.score == pytest.approx(w.score, abs=1e-2)
