"""HTK hmmdefs (ascii) reader -> flattened HMMSet.

Replaces the reference's linked-struct parser
(`libsent/src/hmminfo/rdhmmdef.c:262` + per-section readers
rdhmmdef_{state,dens,var,trans,tiedmix,mpdf,streamweight,options}.c) with a
single-pass tokenizer that emits flat numpy arrays directly (models/hmm.py).

Supported: diagonal-covariance Gaussians, mixture states, macro types
~o ~h ~s ~m ~v ~u ~t ~w ~p, tied-mixture codebooks (<TMIX>, codebook
member densities named "<book><k>" like reference
rdhmmdef_tiedmix.c:tmix_create_codebook_index), embedded DNN state ids
(<SID>, reference rdhmmdef_state.c:131).  Multi-stream models are parsed
but only single-stream scoring is flattened for now.
"""

from __future__ import annotations

import gzip
import math
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from julius_tpu_torch.models.hmm import HMMSet
from julius_tpu_torch.utils.logadd import LOG_ZERO

LOG_2PI = math.log(2.0 * math.pi)

_TOKEN_RE = re.compile(r'"[^"]*"|<[^>]+>|\S+')

PARAM_KINDS = {
    "WAVEFORM", "LPC", "LPREFC", "LPCEPSTRA", "LPDELCEP", "IREFC",
    "MFCC", "FBANK", "MELSPEC", "USER", "DISCRETE", "PLP",
}


def _open_maybe_gz(path: str):
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rt", encoding="latin-1")
    return open(path, "rt", encoding="latin-1")


class _Tokens:
    """Stream tokenizer over the whole file (HTK defs are whitespace-based;
    quoted strings hold macro names)."""

    def __init__(self, text: str):
        self.toks = _TOKEN_RE.findall(text)
        self.pos = 0

    def peek(self) -> Optional[str]:
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def next(self) -> str:
        t = self.peek()
        if t is None:
            raise ValueError("unexpected end of hmmdefs")
        self.pos += 1
        return t

    def next_name(self) -> str:
        t = self.next()
        return t[1:-1] if t.startswith('"') else t

    def next_int(self) -> int:
        return int(self.next())

    def next_float(self) -> float:
        return float(self.next())

    def next_floats(self, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.float32)
        for i in range(n):
            out[i] = float(self.next())
        return out

    def is_kw(self, *names: str) -> bool:
        t = self.peek()
        if t is None or not t.startswith("<"):
            return False
        return t[1:-1].upper() in names


class _Builder:
    def __init__(self):
        self.means: List[np.ndarray] = []
        self.ivars: List[np.ndarray] = []
        self.gconst: List[float] = []
        self.states: List[List[Tuple[int, float]]] = []  # [(gauss, ln w)]
        self.state_sid: List[int] = []
        self.hmms: List[Tuple[List[int], np.ndarray]] = []  # (senone ids, trans)
        self.hmm_names: List[str] = []
        # macros
        self.var_macros: Dict[str, np.ndarray] = {}
        self.mean_macros: Dict[str, np.ndarray] = {}
        self.dens_macros: Dict[str, int] = {}      # ~m name -> gauss id
        self.state_macros: Dict[str, int] = {}     # ~s name -> state id
        self.trans_macros: Dict[str, np.ndarray] = {}
        self.sw_macros: Dict[str, np.ndarray] = {}
        self.codebooks: Dict[str, List[int]] = {}  # book name -> gauss ids
        self.vecsize = 0
        self.param_kind: Optional[str] = None
        self.stream_widths: List[int] = []
        self.has_sid = False

    def add_gauss(self, mean: np.ndarray, var: np.ndarray,
                  gconst: Optional[float]) -> int:
        if gconst is None:
            gconst = float(len(var) * LOG_2PI + np.sum(np.log(var)))
        self.means.append(mean)
        self.ivars.append(1.0 / np.maximum(var, 1e-20))
        self.gconst.append(gconst)
        return len(self.means) - 1

    def add_state(self, mixes: List[Tuple[int, float]], sid: int) -> int:
        self.states.append(mixes)
        self.state_sid.append(sid)
        return len(self.states) - 1


def _parse_options(tk: _Tokens, b: _Builder):
    """~o global options (reference rdhmmdef_options.c)."""
    while True:
        t = tk.peek()
        if t is None or t.startswith("~"):
            return
        if not t.startswith("<"):
            return
        kw = t[1:-1].upper()
        if kw == "STREAMINFO":
            tk.next()
            n = tk.next_int()
            b.stream_widths = [tk.next_int() for _ in range(n)]
        elif kw == "VECSIZE":
            tk.next()
            b.vecsize = tk.next_int()
        elif kw == "MSDINFO":
            tk.next()
            n = tk.next_int()
            for _ in range(n):
                tk.next()
        elif kw == "HMMSETID":
            tk.next()
            tk.next()
        elif kw.split("_")[0] in PARAM_KINDS:
            tk.next()
            b.param_kind = kw
        else:
            # covariance kind / duration kind flags: DIAGC NULLD etc.
            tk.next()


def _parse_mean_var(tk: _Tokens, b: _Builder):
    """Inline or macro-referenced <MEAN>/<VARIANCE>[/<GCONST>] -> gauss id."""
    t = tk.peek()
    if t == "~m":
        tk.next()
        name = tk.next_name()
        if name not in b.dens_macros:
            raise ValueError(f"undefined ~m macro {name}")
        return b.dens_macros[name]
    # mean
    if tk.peek() == "~u":
        tk.next()
        mean = b.mean_macros[tk.next_name()]
    else:
        if not tk.is_kw("MEAN"):
            raise ValueError(f"expected <MEAN>, got {tk.peek()}")
        tk.next()
        n = tk.next_int()
        mean = tk.next_floats(n)
    # variance
    if tk.peek() == "~v":
        tk.next()
        var = b.var_macros[tk.next_name()]
    else:
        if not tk.is_kw("VARIANCE"):
            if tk.is_kw("INVCOVAR", "LLTCOVAR", "XFORM"):
                raise NotImplementedError(
                    "full-covariance models are not supported (the reference "
                    "also only scores diagonal models, calc_mix.c)")
            raise ValueError(f"expected <VARIANCE>, got {tk.peek()}")
        tk.next()
        n = tk.next_int()
        var = tk.next_floats(n)
    gconst = None
    if tk.is_kw("GCONST"):
        tk.next()
        gconst = tk.next_float()
    return b.add_gauss(mean, var, gconst)


def _parse_state(tk: _Tokens, b: _Builder) -> int:
    """State body after <STATE> n or for ~s macro def
    (reference rdhmmdef_state.c)."""
    t = tk.peek()
    if t == "~s":
        tk.next()
        name = tk.next_name()
        if name not in b.state_macros:
            raise ValueError(f"undefined ~s macro {name}")
        return b.state_macros[name]

    sid = -1
    nmix = [1]
    if tk.is_kw("SID"):
        tk.next()
        sid = tk.next_int()
        b.has_sid = True
    if tk.is_kw("NUMMIXES"):
        tk.next()
        nstr = max(1, len(b.stream_widths))
        nmix = [tk.next_int() for _ in range(nstr)]
    if tk.is_kw("SWEIGHTS") or tk.peek() == "~w":
        if tk.peek() == "~w":
            tk.next()
            tk.next_name()
        else:
            tk.next()
            n = tk.next_int()
            tk.next_floats(n)
    if len(b.stream_widths) > 1:
        raise NotImplementedError("multi-stream scoring not yet flattened")

    mixes: List[Tuple[int, float]] = []
    if tk.is_kw("TMIX"):
        tk.next()
        book = tk.next_name()
        gids = b.codebooks.get(book)
        if gids is None:
            raise ValueError(f"undefined tied-mixture codebook {book}")
        for k in range(nmix[0]):
            w = tk.next_float()
            if w > 0.0 and k < len(gids) and gids[k] >= 0:
                mixes.append((gids[k], math.log(w)))
    else:
        while True:
            if tk.is_kw("STREAM"):
                tk.next()
                tk.next_int()
                continue
            if tk.is_kw("MIXTURE"):
                tk.next()
                tk.next_int()       # mixture index (1-based)
                w = tk.next_float()
                gid = _parse_mean_var(tk, b)
                if w > 0.0:
                    mixes.append((gid, math.log(w)))
            elif tk.peek() in ("~m",) or tk.is_kw("MEAN") or tk.peek() == "~u":
                gid = _parse_mean_var(tk, b)
                mixes.append((gid, 0.0))
            else:
                break
    if not mixes:
        raise ValueError("state with no mixtures")
    return b.add_state(mixes, sid)


def _parse_transp(tk: _Tokens, b: _Builder) -> np.ndarray:
    t = tk.peek()
    if t == "~t":
        tk.next()
        name = tk.next_name()
        return b.trans_macros[name]
    if not tk.is_kw("TRANSP"):
        raise ValueError(f"expected <TRANSP>, got {tk.peek()}")
    tk.next()
    n = tk.next_int()
    probs = tk.next_floats(n * n).reshape(n, n).astype(np.float64)
    with np.errstate(divide="ignore"):
        ln = np.where(probs > 0, np.log(probs), LOG_ZERO)
    return ln.astype(np.float32)


def _parse_hmm(tk: _Tokens, b: _Builder, name: str):
    if not tk.is_kw("BEGINHMM"):
        raise ValueError(f"expected <BEGINHMM>, got {tk.peek()}")
    tk.next()
    if tk.is_kw("NUMSTATES"):
        tk.next()
    nstates = tk.next_int()
    state_ids = [-1] * (nstates - 2)
    while tk.is_kw("STATE"):
        tk.next()
        idx = tk.next_int()     # 2 .. nstates-1
        state_ids[idx - 2] = _parse_state(tk, b)
    trans = _parse_transp(tk, b)
    if trans.shape[0] != nstates:
        raise ValueError(
            f"hmm {name}: transP size {trans.shape[0]} != NUMSTATES {nstates}")
    if not tk.is_kw("ENDHMM"):
        raise ValueError(f"expected <ENDHMM> in {name}, got {tk.peek()}")
    tk.next()
    if any(s < 0 for s in state_ids):
        raise ValueError(f"hmm {name}: missing state definitions")
    b.hmm_names.append(name)
    b.hmms.append((state_ids, trans))


def parse_hmmdefs_text(text: str) -> HMMSet:
    tk = _Tokens(text)
    b = _Builder()
    pending_tmix_states: List[Tuple[str, int, List[float], int]] = []

    while tk.peek() is not None:
        t = tk.next()
        if t == "~o":
            _parse_options(tk, b)
        elif t == "~v":
            name = tk.next_name()
            tk.next()  # <VARIANCE>
            n = tk.next_int()
            b.var_macros[name] = tk.next_floats(n)
        elif t == "~u":
            name = tk.next_name()
            tk.next()  # <MEAN>
            n = tk.next_int()
            b.mean_macros[name] = tk.next_floats(n)
        elif t == "~m":
            name = tk.next_name()
            gid = _parse_mean_var(tk, b)
            b.dens_macros[name] = gid
            # register into codebook if the name looks like "<book><k>"
            m = re.match(r"^(.*?)(\d+)$", name)
            if m:
                book, k = m.group(1), int(m.group(2))
                lst = b.codebooks.setdefault(book, [])
                while len(lst) < k:
                    lst.append(-1)
                lst[k - 1] = gid
        elif t == "~t":
            name = tk.next_name()
            b.trans_macros[name] = _parse_transp(tk, b)
        elif t == "~w":
            name = tk.next_name()
            tk.next()  # <SWEIGHTS>
            n = tk.next_int()
            b.sw_macros[name] = tk.next_floats(n)
        elif t == "~s":
            name = tk.next_name()
            b.state_macros[name] = _parse_state(tk, b)
        elif t == "~p":
            # stream pdf macro (reference rdhmmdef_mpdf.c) — treat as state
            name = tk.next_name()
            b.state_macros[name] = _parse_state(tk, b)
        elif t == "~h":
            name = tk.next_name()
            _parse_hmm(tk, b, name)
        elif t.startswith("<"):
            # hmmdefs may start with options without ~o in some dumps
            tk.pos -= 1
            _parse_options(tk, b)
        else:
            raise ValueError(f"unexpected token at top level: {t}")

    return _finalize(b)


def _finalize(b: _Builder) -> HMMSet:
    if not b.hmms:
        raise ValueError("no ~h HMM definitions found")
    G = len(b.means)
    D = b.vecsize or (len(b.means[0]) if b.means else 0)
    S = len(b.states)
    M = max(len(s) for s in b.states)
    P = len(b.hmms)
    NS = max(len(h[0]) for h in b.hmms)

    means = np.stack(b.means).astype(np.float32)
    ivars = np.stack(b.ivars).astype(np.float32)
    gconst = np.asarray(b.gconst, dtype=np.float32)

    state_mix = np.full((S, M), -1, dtype=np.int32)
    state_lw = np.full((S, M), LOG_ZERO, dtype=np.float32)
    for i, mixes in enumerate(b.states):
        for j, (g, lw) in enumerate(mixes):
            state_mix[i, j] = g
            state_lw[i, j] = lw
    if b.has_sid:
        state_sid = np.asarray(b.state_sid, dtype=np.int32)
    else:
        state_sid = np.arange(S, dtype=np.int32)

    phone_states = np.full((P, NS), -1, dtype=np.int32)
    phone_ns = np.zeros(P, dtype=np.int32)
    phone_trans = np.full((P, NS + 2, NS + 2), LOG_ZERO, dtype=np.float32)
    for i, (sids, trans) in enumerate(b.hmms):
        ns = len(sids)
        phone_ns[i] = ns
        phone_states[i, :ns] = sids
        phone_trans[i, : ns + 2, : ns + 2] = trans

    names_are_tri = any(("-" in n or "+" in n) for n in b.hmm_names)
    return HMMSet(
        means=means,
        ivars=ivars,
        gconst=gconst,
        state_mix=state_mix,
        state_lw=state_lw,
        state_sid=state_sid,
        phone_states=phone_states,
        phone_ns=phone_ns,
        phone_trans=phone_trans,
        phone_names=list(b.hmm_names),
        phone_index={n: i for i, n in enumerate(b.hmm_names)},
        logical_map={},
        veclen=D,
        param_kind=b.param_kind,
        names_are_triphone=names_are_tri,
    )


def load_hmmdefs(path: str) -> HMMSet:
    """Load an ascii (optionally gzipped) HTK hmmdefs file."""
    with _open_maybe_gz(path) as f:
        return parse_hmmdefs_text(f.read())
