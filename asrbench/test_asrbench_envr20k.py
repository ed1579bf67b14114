"""The envr20k configuration (asrbench/configs/envr20k.py) on the CPU:
its senone count exact over clusters of uneven size, every triphone its
vocabulary composes resolved, strict heads that differ from pass 1's
pseudo sets, and tiny copies of its cells held to the reference."""

import io

import numpy as np
import pytest
import torch

from asrbench import harness
from asrbench.conftest import tiny_cell
from asrbench.reference.lexicon import Lexicon, center

CFG = harness.load_json(harness.HERE / "configs" / "envr20k.json")
BUILDER = harness.load_module(harness.HERE / "configs" / "envr20k.py")
CELLS = [c["name"] for c in harness.load_json(
    harness.ROOT / "BENCHMARK.json")["workloads"]
    if c["config"] == "envr20k"]
#: a configuration small enough to decode in seconds, its clusters uneven
SMALL = dict(feat_dim=6, input_size=66, hidden_size=32, num_hidden_layers=2,
             num_phones=6, variants=4, num_senones=47, vocab_size=40)


def small_config(**kw):
    cfg = dict(CFG, **SMALL)
    cfg["search"] = dict(CFG["search"], trellis_topm=6)
    cfg.update(kw)
    return cfg


@pytest.fixture(scope="module")
def full():
    return BUILDER.build(CFG, 12345)


@pytest.mark.parametrize("senones,clusters,cap", [
    (4874, 120, 51), (47, 18, 5), (18, 18, 1), (35, 35, 51), (90, 18, 5)])
@pytest.mark.parametrize("shape", [0.5, 8.0])
def test_cluster_sizes_sum_exactly_within_their_cap(senones, clusters, cap,
                                                    shape):
    sizes = BUILDER.cluster_sizes(senones, clusters, shape, cap,
                                  np.random.default_rng(3))
    assert len(sizes) == clusters and int(sizes.sum()) == senones
    assert sizes.min() >= 1 and sizes.max() <= cap
    if clusters < senones < clusters * cap:
        assert sizes.max() > sizes.min()
    with pytest.raises(ValueError):
        BUILDER.cluster_sizes(clusters * cap + 1, clusters, shape, cap,
                              np.random.default_rng(3))


def test_fewer_senones_than_positions_tie_the_silence_phone():
    pos, sizes = BUILDER.position_clusters(35, 12, 51, 4.0,
                                           np.random.default_rng(0))
    assert list(pos[-2:]) == [34, 34] and int(sizes.sum()) == 35
    with pytest.raises(ValueError):
        BUILDER.position_clusters(33, 12, 51, 4.0, np.random.default_rng(0))


def test_the_full_model_has_the_published_widths(full):
    m = full
    assert m.n_states == CFG["num_senones"] == 4874
    assert len(m.names) == CFG["vocab_size"] == 20000
    assert [w.shape for w in m.weights] == \
        [(528, 1536)] + [(1536, 1536)] * 4
    assert m.out_w.shape == (1536, 4874) and m.protos.shape == (4874, 48)
    assert m.triphone and len(m.phone_names) == 40 * 51
    assert m.phone_names[:40] == BUILDER.base_phone_names(40)
    # every senone is some physical phone's state, and each position's
    # cluster holds senones no other position uses
    used = np.unique(m.phone_states)
    assert len(used) == 4874
    pos = {}
    for p in range(len(m.phone_names)):
        for s in range(3):
            b = p if p < 40 else (p - 40) // 50
            pos.setdefault(int(m.phone_states[p, s]), set()).add((b, s))
    assert all(len(v) == 1 for v in pos.values())
    sizes = np.bincount([b * 3 + s for v in pos.values() for b, s in v])
    assert sizes.sum() == 4874 and sizes.max() > 2 * sizes.min()


def test_the_model_is_the_configurations_not_the_runs(full):
    again = BUILDER.build(CFG, 999)
    assert again.names == full.names and again.bi == full.bi
    assert np.array_equal(again.out_w, full.out_w)


def test_every_triphone_the_vocabulary_composes_resolves(full):
    m = full
    index = m.phone_index
    bases = m.phone_names[:40]

    def resolves(name):
        return name in m.logical_map or name in index

    finals = {center(ph[-1]) for ph in m.phones}
    heads = set()
    for ph in m.phones:
        n = len(ph)
        for i in range(1, n - 1):
            assert resolves(f"{ph[i - 1]}-{ph[i]}+{ph[i + 1]}")
        if n > 1:
            heads.add(f"{ph[0]}+{ph[1]}")
            for rc in bases:
                assert resolves(f"{ph[-2]}-{ph[-1]}+{rc}")
    for h in heads:
        for lc in finals:
            assert resolves(f"{lc}-{h}")


def test_strict_heads_differ_from_the_pseudo_max_on_some_seam():
    m = BUILDER.build(small_config(), 0)
    lex = Lexicon(m)
    assert lex.members and max(len(s) for s in lex.members) > 1
    rng = torch.Generator().manual_seed(0)
    senone = torch.randn(50, m.n_states, generator=rng, dtype=torch.float64)
    ext = lex.extend(senone, "max")
    differ = 0
    for w in range(2, len(m.names)):
        for prev in range(len(m.names)):
            head = lex.strict_head(w, prev)
            if head is None:
                continue
            pseudo = lex.cols[w, :len(head)]
            assert (pseudo >= lex.S).all()      # pass 1 reads pseudo sets
            # the exact triphone is a member of its pseudo set, so the
            # max is never below it
            assert (ext[:, pseudo] >= ext[:, head]).all()
            differ += int((ext[:, pseudo] > ext[:, head]).any())
    assert differ > 0


@pytest.mark.parametrize("workload", CELLS)
def test_a_tiny_copy_of_the_cell_is_correct(workload):
    cfg, traffic = tiny_cell(workload)
    # clusters of more than one senone, so that pseudo sets aggregate
    cfg.update(num_senones=60, variants=4)
    out = io.StringIO()
    line = harness.run_cell(workload, 2**31 + 17, 0.3, False, device="cpu",
                            config=cfg, traffic=traffic, out=out,
                            err=io.StringIO())
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert ("nbest_gap" in line["checks"]) == workload.endswith("batch16")
