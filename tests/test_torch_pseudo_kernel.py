"""The pseudo set-states' scores on the card (ops/pseudo_kernel.py,
csrc/pseudo.cu) and the engine's use of them (`Engine._extend`).

On the CPU:
  * the sliced member table (32 set-states a slice, their lists side by
    side, -1 past each list's end) holds every member list of envr20k's
    network, of the lvcsr network and of synthetic tables (an empty
    set-state, one of over 64 members, Q' not a multiple of 32) in
    order; `Engine._setup_pseudo_arrays` builds it once, from the
    network's `member_ofs`, beside the plain version's arrays;
  * a numpy mirror of the kernel's arithmetic (a slice at a time, a lane
    a set-state, the members in table order; max, the peel-max rounds of
    best, avg's sums in member order, every f32 op rounded once) is
    bit-equal to the plain version, `aggregate_pseudo_plain`, under
    every scheme, on rows with exact integer ties and all-LOG_ZERO rows;
  * `aggregate_pseudo` sends CPU tensors to the plain version (no
    launch) and the kernel's wrapper refuses them; `Engine._extend` on
    the CPU gives the plain version's extended rows and counts its chunks
    and no launch; `plan` picks the rows a block from S.

On a card (skipped without one): the kernel bit-equal to the plain
version on the same tables and schemes, both its outputs (the [..., Q']
scores and the extended rows), with the rows in shared memory (8 or 4 a
block) and in device memory; one launch a call, counted by `LAUNCHES`
and by the engine's `pseudo.kernel` / `pseudo.chunks`; the wrapper
raising on what the kernel does not take.  The card's cases import
neither JAX nor the reference package:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_pseudo_kernel.py
"""

import numpy as np
import pytest
import torch

from asrbench import harness
from asrbench.program import build_engine
from julius_tpu_torch.ops import gmm
from julius_tpu_torch.ops import pseudo_kernel as pk
from julius_tpu_torch.tools import synth
from julius_tpu_torch.utils import trace

from torch_fixtures import LOG_ZERO

NEG_HALF = np.float32(LOG_ZERO / 2)
ENVR20K = harness.load_json(harness.HERE / "configs" / "envr20k.json")
BUILDER = harness.load_module(harness.HERE / "configs" / "envr20k.py")
#: (scheme, nbest) of every case
SCHEMES = [("max", 1), ("best", 1), ("best", 2), ("best", 3), ("best", 5),
           ("avg", 3)]
#: envr20k at a small size, for an engine on the card
SMALL = dict(feat_dim=6, input_size=66, hidden_size=32, num_hidden_layers=2,
             num_phones=8, variants=5, num_senones=80, vocab_size=300)


def synthetic_table(seed, S=300, Q=77):
    """(members, member_ofs, S) of Q set-states of 0-70 members each,
    ids sorted within a set-state: set-state 3 empty, set-state 40 of 70
    members."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 30, Q)
    sizes[3], sizes[40], sizes[-1] = 0, 70, 1
    members = np.concatenate([np.sort(rng.choice(S, n, replace=False))
                              for n in sizes]).astype(np.int32)
    return members, np.concatenate([[0], np.cumsum(sizes)]), S


@pytest.fixture(scope="module")
def tables():
    """{name: (members, member_ofs, S)}: envr20k's network at full size,
    the lvcsr network at a small size, two synthetic tables."""
    eng = build_engine(BUILDER.build(ENVR20K, 0), "cpu", enable_pass2=False)
    lv, _ = synth.lvcsr_engine(device="cpu", n_words=400, hidden=256,
                               n_layers=2)
    out = {}
    for name, e in (("envr20k", eng), ("lvcsr", lv)):
        ps = e.net.pseudo
        out[name] = (np.asarray(ps.members), np.asarray(ps.member_ofs),
                     e.hmm.n_states)
    out["synthetic"] = synthetic_table(1)
    out["wide_rows"] = synthetic_table(2, S=20000, Q=45)
    return out


def score_rows(seed, N, S):
    """[N, S] f32 integer scores (members of a set-state tie often), 30%
    LOG_ZERO, row 0 all LOG_ZERO."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(-6, 0, (N, S)).astype(np.float32)
    rows[rng.random(rows.shape) < 0.3] = LOG_ZERO
    rows[0] = LOG_ZERO
    return rows


def segments(members, ofs):
    """The plain version's (members, segids) int64 tensors."""
    seg = np.repeat(np.arange(len(ofs) - 1), np.diff(ofs))
    return (torch.as_tensor(np.asarray(members, np.int64)),
            torch.as_tensor(seg, dtype=torch.int64))


def plain(members, ofs, rows, scheme, nbest):
    mem, seg = segments(members, ofs)
    return gmm.aggregate_pseudo_plain(mem, seg, len(ofs) - 1,
                                      torch.from_numpy(rows), scheme, nbest)


def kernel_mirror(rows, slices, ids, Q, scheme, nbest):
    """The kernel's arithmetic in numpy: [N, S] f32 rows -> [N, Q]."""
    N = rows.shape[0]
    f32 = np.float32
    out = np.empty((N, Q), f32)
    for sl in range(len(slices) - 1):
        col = ids[slices[sl]:slices[sl + 1]]              # [W, 32]
        xs = [(c >= 0, rows[:, np.maximum(c, 0)]) for c in col]
        shape = (N, pk.SLICE)
        if scheme == "avg":
            s, c = np.zeros(shape, f32), np.zeros(shape, f32)
            for ok, x in xs:
                take = ok & (x > NEG_HALF)
                s = np.where(take, s + x, s)
                c = np.where(take, c + f32(1), c)
            res = np.where(c > 0, s / np.maximum(c, f32(1)), f32(LOG_ZERO))
        elif scheme == "best" and nbest > 1:
            prev, s, c = (np.zeros(shape, f32) for _ in range(3))
            live = np.ones(shape, bool)
            for rnd in range(nbest):
                m = np.full(shape, -np.inf, f32)
                for ok, x in xs:
                    take = ok & ((rnd == 0) | (x < prev))
                    m = np.where(take, np.maximum(m, x), m)
                has = m > NEG_HALF
                s = np.where(live & has, s + m, s)
                c = np.where(live & has, c + f32(1), c)
                prev = np.where(live & has, m, prev)
                s = np.where(live & ~has, s + f32(0), s)
                live &= has
                if not live.any():
                    break
            res = np.where(c > 0, s / np.maximum(c, f32(1)), f32(LOG_ZERO))
        else:
            res = np.full(shape, -np.inf, f32)
            for ok, x in xs:
                res = np.where(ok, np.maximum(res, x), res)
        q0 = sl * pk.SLICE
        out[:, q0:q0 + pk.SLICE] = res[:, :Q - q0]
    return out


# ---- the CPU ----------------------------------------------------------

@pytest.mark.parametrize("name", ["envr20k", "lvcsr", "synthetic",
                                  "wide_rows"])
def test_the_sliced_table_holds_every_member_list_in_order(tables, name):
    members, ofs, S = tables[name]
    slices, ids = pk.sliced(members, ofs)
    Q = len(ofs) - 1
    assert slices.dtype == ids.dtype == np.int32
    assert len(slices) == -(-Q // pk.SLICE) + 1 and slices[0] == 0
    assert ids.shape == (slices[-1], pk.SLICE)
    sizes = np.diff(ofs)
    for q in range(Q):
        s, j = divmod(q, pk.SLICE)
        col = ids[slices[s]:slices[s + 1], j]
        n = sizes[q]
        np.testing.assert_array_equal(col[:n], members[ofs[q]:ofs[q + 1]])
        assert (col[n:] == -1).all()
    # each slice as wide as its longest list; lanes past Q' all padding
    widths = np.diff(slices)
    padded = np.zeros(len(widths) * pk.SLICE, np.int64)
    padded[:Q] = sizes
    np.testing.assert_array_equal(
        widths, padded.reshape(-1, pk.SLICE).max(axis=1))
    tail = Q % pk.SLICE
    if tail:
        assert (ids[slices[-2]:, tail:] == -1).all()


def test_the_table_refuses_what_it_cannot_hold():
    with pytest.raises(ValueError):
        pk.sliced(np.arange(4), [0, 3, 2, 4])            # falling offsets
    with pytest.raises(ValueError):
        pk.sliced(np.arange(4), [0, 2, 3])               # short of L
    with pytest.raises(ValueError):
        pk.sliced(np.array([0, -1, 2]), [0, 2, 3])       # a negative id


def test_the_engine_builds_the_kernels_table_once_from_member_ofs(tables):
    eng = build_engine(BUILDER.build(dict(ENVR20K, **SMALL), 0), "cpu")
    ps = eng.net.pseudo
    tab = eng._pseudo_kernel
    slices, ids = pk.sliced(ps.members, ps.member_ofs)
    np.testing.assert_array_equal(tab.slices.numpy(), slices)
    np.testing.assert_array_equal(tab.ids.numpy(), ids)
    assert tab.n_pseudo == eng._pseudo[2] == ps.n_set_states
    assert tab.max_id == int(np.max(ps.members)) < eng.hmm.n_states
    # the plain version's arrays list the same members in the same order
    mem, seg, nq = eng._pseudo
    assert mem.dtype == seg.dtype == torch.int64
    np.testing.assert_array_equal(mem.numpy(), ps.members)
    np.testing.assert_array_equal(
        np.searchsorted(seg.numpy(), np.arange(nq + 1)), ps.member_ofs)
    again = pk.tables_from_segments(mem, seg, nq, "cpu")
    assert torch.equal(again.slices, tab.slices)
    assert torch.equal(again.ids, tab.ids)


@pytest.mark.parametrize("scheme,nbest", SCHEMES)
@pytest.mark.parametrize("name", ["envr20k", "lvcsr", "synthetic"])
def test_the_kernels_arithmetic_is_bit_equal_to_the_plain_version(
        tables, name, scheme, nbest):
    members, ofs, S = tables[name]
    rows = score_rows(len(scheme) + nbest, 11, S)
    slices, ids = pk.sliced(members, ofs)
    got = kernel_mirror(rows, slices, ids, len(ofs) - 1, scheme, nbest)
    want = plain(members, ofs, rows, scheme, nbest).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if name == "synthetic":
        empty = want[:, 3]
        assert (empty == (-np.inf if scheme in ("max", "best") and nbest < 2
                          else LOG_ZERO)).all()
    assert (want[0] <= LOG_ZERO).all()           # the all-LOG_ZERO row


@pytest.mark.parametrize("extend", [False, True])
def test_cpu_tensors_take_the_plain_version(tables, extend):
    members, ofs, S = tables["synthetic"]
    mem, seg = segments(members, ofs)
    Q = len(ofs) - 1
    rows = torch.from_numpy(score_rows(5, 2 * 9, S).reshape(2, 9, S))
    tab = pk.build_tables(members, ofs, "cpu")
    launches = pk.LAUNCHES
    got = gmm.aggregate_pseudo(mem, seg, Q, rows, "best", 3, tables=tab,
                               extend=extend)
    want = gmm.aggregate_pseudo_plain(mem, seg, Q, rows, "best", 3)
    if extend:
        want = torch.cat([rows, want], dim=-1)
    assert torch.equal(got, want) and got.shape == want.shape
    assert pk.LAUNCHES == launches
    with pytest.raises(ValueError):
        pk.aggregate(rows, tab, "best", 3)


def test_the_engine_extends_cpu_rows_with_the_plain_version():
    eng = build_engine(BUILDER.build(dict(ENVR20K, **SMALL), 0), "cpu")
    S = eng.hmm.n_states
    mem, seg, nq = eng._pseudo
    rows = torch.from_numpy(score_rows(9, 3 * 13, S).reshape(3, 13, S))
    trace.drain_counts()
    trace.enable(True)
    try:
        out = eng._extend(rows)
        counts = trace.drain_counts()
    finally:
        trace.enable(False)
    want = torch.cat([rows, gmm.aggregate_pseudo_plain(
        mem, seg, nq, rows, eng.am_cfg.iwcd_scheme,
        eng.am_cfg.iwcd_nbest)], dim=-1)
    assert torch.equal(out, want)
    n = 3 * 13
    assert counts == {"pseudo.rows": n, "pseudo.kernel": 0,
                      "pseudo.chunks": -(-n // gmm.chunk_rows(
                          n, int(mem.shape[0])))}


@pytest.mark.parametrize("S,plan", [(80, (2, True)), (4874, (2, True)),
                                    (7263, (2, True)), (7264, (1, True)),
                                    (14527, (1, True)), (14528, (1, False))])
def test_rows_a_block_follow_from_the_row_width(S, plan):
    assert pk.plan(S) == plan


# ---- the card ---------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def card_case(cuda, tables, name, scheme, nbest, extend, N=74):
    members, ofs, S = tables[name]
    rows = score_rows(N + len(scheme) + nbest, N, S).reshape(2, N // 2, S)
    want = plain(members, ofs, rows.reshape(N, S), scheme, nbest)
    want = want.reshape(2, N // 2, -1)
    if extend:
        want = torch.cat([torch.from_numpy(rows), want], dim=-1)
    tab = pk.build_tables(members, ofs, cuda)
    launches = pk.LAUNCHES
    got = pk.aggregate(torch.from_numpy(rows).to(cuda), tab, scheme, nbest,
                       extend)
    torch.cuda.synchronize()
    assert pk.LAUNCHES == launches + 1
    return got.cpu(), want


@pytest.mark.cuda
@pytest.mark.parametrize("extend", [False, True])
@pytest.mark.parametrize("scheme,nbest", SCHEMES)
@pytest.mark.parametrize("name", ["envr20k", "lvcsr", "synthetic",
                                  "wide_rows"])
def test_kernel_is_bit_equal_to_the_plain_version(cuda, tables, name,
                                                  scheme, nbest, extend):
    got, want = card_case(cuda, tables, name, scheme, nbest, extend)
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [(1, True), (1, False)])
@pytest.mark.parametrize("scheme,nbest", [("max", 1), ("best", 3),
                                          ("avg", 3)])
def test_every_plan_gives_the_same_bits(cuda, tables, monkeypatch, plan,
                                        scheme, nbest):
    monkeypatch.setattr(pk, "plan", lambda S: plan)
    got, want = card_case(cuda, tables, "envr20k", scheme, nbest, True,
                          N=38)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_the_wrapper_refuses_what_the_kernel_does_not_take(cuda, tables):
    members, ofs, S = tables["synthetic"]
    tab = pk.build_tables(members, ofs, cuda)
    rows = torch.zeros((4, S), device=cuda)
    with pytest.raises(TypeError):
        pk.aggregate(rows.double(), tab)
    with pytest.raises(ValueError):
        pk.aggregate(torch.zeros((S, 4), device=cuda).t(), tab)
    with pytest.raises(ValueError):
        pk.aggregate(rows[:, :S - 1], tab)           # ids up to S - 1
    with pytest.raises(ValueError):
        pk.aggregate(rows, pk.build_tables(members, ofs, "cpu"))
    with pytest.raises(ValueError):
        pk.aggregate(rows, tab, "mean")
    launches = pk.LAUNCHES
    assert pk.aggregate(rows[:0], tab).shape == (0, len(ofs) - 1)
    assert pk.LAUNCHES == launches


@pytest.mark.cuda
def test_the_engine_launches_once_a_call_and_counts_it(cuda):
    model = BUILDER.build(dict(ENVR20K, **SMALL), 0)
    eng = build_engine(model, "cuda")
    cpu = build_engine(model, "cpu")
    S = eng.hmm.n_states
    rows = torch.from_numpy(score_rows(3, 4 * 50, S).reshape(4, 50, S))
    trace.drain_counts()
    trace.enable(True)
    try:
        launches = pk.LAUNCHES
        got = eng._extend(rows.to(cuda))
        torch.cuda.synchronize()
        counts = trace.drain_counts()
    finally:
        trace.enable(False)
    assert pk.LAUNCHES == launches + 1
    assert counts == {"pseudo.rows": 200, "pseudo.kernel": 1,
                      "pseudo.chunks": 1}
    assert torch.equal(got.cpu(), cpu._extend(rows))
