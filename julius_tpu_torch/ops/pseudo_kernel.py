"""The pseudo set-states' scores on the card: the hand-written CUDA
kernel (csrc/pseudo.cu) and its tables.

No TPU kernel stands behind it: the reference aggregates in XLA
(`julius_tpu/ops/gmm.py` `aggregate_pseudo`), and so does the plain
version, ops/gmm.py `aggregate_pseudo_plain` (row chunks gathered by
`index_select`, reduced by `scatter_reduce`).  ops/gmm.py
`aggregate_pseudo` sends CPU tensors there and CUDA tensors here.

`aggregate(senone, tables, scheme, nbest, extend)` gives the [..., Q']
pseudo set-state scores of senone rows [..., S], or with `extend` the
extended rows [..., S + Q'] (the senone columns, then the set-states'),
in one launch on the rows' card, bit-equal to the plain version under
every scheme (csrc/pseudo.cu says how).  It takes CUDA tensors only, and
raises on anything else the kernel does not take.  `LAUNCHES` counts
launches.

The kernel reads the member ids as a sliced table (`sliced`): the
set-states in slices of 32, a slice's member lists side by side, padded
with -1 to its longest, so that a warp, a lane a set-state, reads one
coalesced line an entry.  `build_tables` makes it once, from a network's
`PseudoPhoneSets.members` / `member_ofs`; `tables_from_segments` from
the plain version's (members, segids).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from julius_tpu_torch.ops import cuda_build
from julius_tpu_torch.utils.logadd import LOG_ZERO

SOURCE = cuda_build.CSRC / "pseudo.cu"

SMEM_MAX = 232448       # shared memory a block may take on an H100
#: set-states a slice of the member table: a warp's lanes
SLICE = 32
#: threads of a block (a group of 4 or 8 rows)
THREADS = 1024
#: the kernel's codes of the -iwcd1 schemes (best with nbest <= 1 is max)
SCHEMES = {"max": 0, "best": 1, "avg": 2}

#: kernel launches made through `aggregate` in this process
LAUNCHES = 0
_lib = None


class PseudoTables(NamedTuple):
    """The kernel's member table of Q' pseudo set-states, on one device."""

    slices: torch.Tensor     # [ceil(Q' / 32) + 1] int32 first entry a slice
    ids: torch.Tensor        # [slices[-1], 32] int32 member ids, -1 padding
    n_pseudo: int            # Q'
    max_id: int              # the largest member id (-1 if none)


def sliced(members, member_ofs) -> Tuple[np.ndarray, np.ndarray]:
    """(slices, ids) of set-states whose members are
    members[member_ofs[q]:member_ofs[q + 1]]: slice s holds set-states
    32 s .. 32 s + 31 in entries slices[s] .. slices[s + 1] - 1, as wide
    as its longest list; ids[slices[s] + k, j] is the k-th member of
    set-state 32 s + j, -1 past the end of its list."""
    mem = np.asarray(members, np.int32)
    ofs = np.asarray(member_ofs, np.int64)
    Q = len(ofs) - 1
    if Q < 0 or ofs[0] != 0 or ofs[-1] != len(mem) or (np.diff(ofs) < 0).any():
        raise ValueError("member_ofs must rise from 0 to len(members)")
    if mem.size and mem.min() < 0:
        raise ValueError("a member id below 0")
    n_sl = -(-Q // SLICE)
    sizes = np.zeros(n_sl * SLICE, np.int64)
    sizes[:Q] = np.diff(ofs)
    slices = np.zeros(n_sl + 1, np.int64)
    np.cumsum(sizes.reshape(n_sl, SLICE).max(axis=1, initial=0),
              out=slices[1:])
    if slices[-1] * SLICE >= 2 ** 31:
        raise ValueError(f"a member table of {slices[-1]} x {SLICE} entries")
    ids = np.full((int(slices[-1]), SLICE), -1, np.int32)
    q = np.repeat(np.arange(Q), sizes[:Q])
    k = np.arange(len(mem)) - ofs[q]
    ids[slices[q // SLICE] + k, q % SLICE] = mem
    return slices.astype(np.int32), ids


def build_tables(members, member_ofs, device) -> PseudoTables:
    """The kernel's tables of a network's pseudo set-states
    (`PseudoPhoneSets.members`, `.member_ofs`) on `device`."""
    slices, ids = sliced(members, member_ofs)
    mem = np.asarray(members)
    return PseudoTables(
        slices=torch.as_tensor(slices, device=device),
        ids=torch.as_tensor(ids, device=device),
        n_pseudo=len(np.asarray(member_ofs)) - 1,
        max_id=int(mem.max()) if mem.size else -1)


def tables_from_segments(members: torch.Tensor, segids: torch.Tensor,
                         n_pseudo: int, device) -> PseudoTables:
    """`build_tables` from the plain version's arrays: members [L]
    grouped by set-state, segids [L] the set-state of each
    (non-decreasing)."""
    seg = np.asarray(segids.cpu(), np.int64)
    if seg.size and (np.diff(seg) < 0).any():
        raise ValueError("segids must not decrease")
    ofs = np.searchsorted(seg, np.arange(int(n_pseudo) + 1))
    return build_tables(np.asarray(members.cpu()), ofs, device)


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library, its C
    interface declared."""
    global _lib
    if _lib is None:
        lib = cuda_build.load(SOURCE)
        vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.pseudo_launch.argtypes = [
            vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i32, i32, i32,
            f32, f32, i32, i32, i32, vp]
        lib.pseudo_launch.restype = i32
        _lib = lib
    return _lib


def plan(S: int) -> Tuple[int, bool]:
    """(G, shared) of a launch over rows of S senones: G groups of 4
    rows a block, as many as shared memory holds (16 bytes a senone a
    group, and 16 for the kernel's slice counter), at most 2; rows wider
    than one group's room stay in device memory (G = 1, shared False)."""
    for G in (2, 1):
        if 16 * G * S + 16 <= SMEM_MAX:
            return G, True
    return 1, False


def aggregate(senone: torch.Tensor, tables: PseudoTables,
              scheme: str = "best", nbest: int = 3,
              extend: bool = False) -> torch.Tensor:
    """The pseudo set-states' scores of the f32 senone rows [..., S] on
    a CUDA card: [..., Q'], or with `extend` [..., S + Q'] (the senone
    columns first), in one launch on the rows' card (none for no rows)."""
    global LAUNCHES
    d = senone.device
    if d.type != "cuda":
        raise ValueError(f"the pseudo kernel takes CUDA tensors, not {d}")
    if scheme not in SCHEMES:
        raise ValueError(f"unknown -iwcd1 scheme {scheme!r}")
    if senone.dtype != torch.float32:
        raise TypeError(f"senone is {senone.dtype}, expected torch.float32")
    if senone.dim() < 1 or not senone.is_contiguous():
        raise ValueError("senone must be a contiguous tensor [..., S]")
    S, Q = int(senone.shape[-1]), int(tables.n_pseudo)
    n_sl = -(-Q // SLICE)
    cuda_build.check_arg("slices", tables.slices, torch.int32, (n_sl + 1,), d)
    cuda_build.check_arg("ids", tables.ids, torch.int32,
                         (tables.ids.shape[0], SLICE), d)
    if not (tables.slices.is_contiguous() and tables.ids.is_contiguous()):
        raise ValueError("the member table must be contiguous")
    if S < 1 or Q < 1 or tables.max_id >= S:
        raise ValueError(f"{Q} set-states over members up to "
                         f"{tables.max_id}, rows of {S} senones")
    lead = senone.shape[:-1]
    N = senone.numel() // S
    width = S + Q if extend else Q
    out = torch.empty((*lead, width), dtype=torch.float32, device=d)
    if N == 0:
        return out
    code = SCHEMES[scheme]
    if scheme == "best" and int(nbest) <= 1:
        code = SCHEMES["max"]
    G, shared = plan(S)
    lib = build()
    with cuda_build.on_device(d):
        rc = lib.pseudo_launch(
            senone.data_ptr(), tables.slices.data_ptr(),
            tables.ids.data_ptr(), out.data_ptr(), N, S, Q, n_sl, width,
            S if extend else 0, int(extend), code, int(nbest), LOG_ZERO,
            LOG_ZERO / 2, G, int(shared), THREADS,
            torch.cuda.current_stream(d).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pseudo kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
