"""Binary HMM (binhmm V2) reader/writer with embedded feature params.

Reference: `libsent/src/hmminfo/read_binhmm.c` / `write_binhmm.c` and the
`mkbinhmm` tool.  All multi-byte fields are BIG-endian (rdn swaps on
little-endian hosts, read_binhmm.c:95-110).  Layout:

  "JBINHMMV2\\0"  qualifiers "\\0" | "_P"(embedded para) "_V"(inversed
  variance) "_M"(mpdf macros) + "\\0"
  [para v3 block if _P]  (write_binhmm.c wt_para field order)
  opt:   i16 nstream, i16 vsize[50], i16 vec_size, cov, dur, param_type
  type:  u8 is_tied_mixture, i32 maxmixturenum
  trans: u32 n; each: name\\0, i16 statenum, f32 a[statenum^2]
  var:   u32 n; each: name\\0, i16 len, f32 vec[len]
  dens:  u32 n; each: name\\0, i16 meanlen, f32 mean[len], u32 varid,
         f32 gconst
  [streamweight if nstream > 1]
  [tmix codebooks if is_tied_mixture]: u32 n; each: name\\0, i32 num,
         u32 densid[num]
  [mpdf if _M]
  state: u32 n; each: name\\0, per stream pdf (i16 mix_num; -1 -> u32
         tmix id, else u32 densid[mix]; f32 bweight[mix]) or u32 mpdf id
  model: u32 n; each: name\\0, i16 state_num, u32 sid[state_num]
         (>= n_states = non-emitting), u32 transid
"""

from __future__ import annotations

import gzip
import struct
from typing import List, Optional, Tuple

import numpy as np

from julius_tpu_torch.config import FrontendConfig
from julius_tpu_torch.models.hmm import HMMSet
from julius_tpu_torch.utils.logadd import LOG_ZERO

# the reference's own LOG_ZERO (stddefs.h:171), used *inside* binhmm
# files for absent transitions/mixture weights
REF_LOG_ZERO = -1000000.0

MAXSTREAMNUM = 50
VALUE_VERSION = 3

# htk_defs.h parameter-kind codes
F_BASE = ["WAVEFORM", "LPC", "LPREFC", "LPCEPSTRA", "LPDELCEP", "IREFC",
          "MFCC", "FBANK", "MELSPEC", "USER", "DISCRETE"]
F_ENERGY = 0x0040
F_ENERGY_SUP = 0x0080
F_DELTA = 0x0100
F_ACCL = 0x0200
F_CEPNORM = 0x0800
F_ZEROTH = 0x2000


class _BE:
    """Big-endian primitive reader over raw bytes."""

    def __init__(self, data: bytes):
        self.d = data
        self.p = 0

    def take(self, n: int) -> bytes:
        b = self.d[self.p: self.p + n]
        if len(b) != n:
            raise ValueError("truncated binhmm file")
        self.p += n
        return b

    def cstr(self) -> str:
        e = self.d.index(b"\x00", self.p)
        s = self.d[self.p: e].decode("latin-1")
        self.p = e + 1
        return s

    def i16(self) -> int:
        return struct.unpack(">h", self.take(2))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self.take(4))[0]

    def u32(self) -> int:
        return struct.unpack(">I", self.take(4))[0]

    def u8(self) -> int:
        return self.take(1)[0]

    def f32(self) -> float:
        return struct.unpack(">f", self.take(4))[0]

    def f32arr(self, n: int) -> np.ndarray:
        return np.frombuffer(self.take(4 * n), dtype=">f4").astype(np.float32)

    def u32arr(self, n: int) -> np.ndarray:
        return np.frombuffer(self.take(4 * n), dtype=">u4").astype(np.int64)


def _para_to_frontend(r: _BE) -> FrontendConfig:
    version = r.i16()
    if version > VALUE_VERSION:
        raise ValueError(f"unknown embedded para version {version}")
    smp_period = r.i32()
    smp_freq = r.i32()
    framesize = r.i32()
    frameshift = r.i32()
    if smp_period == 0 and framesize == 0 and smp_freq != 0 \
            and frameshift != 0:
        # 64-bit-written binhmm quirk (read_binhmm.c:146-156)
        smp_period, smp_freq = smp_freq, frameshift
        framesize = r.i32()
        frameshift = r.i32()
    pre = r.f32()
    lifter = r.i32()
    fbank = r.i32()
    delwin = r.i32()
    accwin = r.i32()
    silfloor = r.f32()
    escale = r.f32()
    hipass = r.i32()
    lopass = r.i32()
    enormal = r.i32()
    raw_e = r.i32()
    if version == 1:
        r.f32()
        r.f32()
    zmeanframe = r.i32()
    usepower = r.i32() if version >= 3 else 0
    cfg = FrontendConfig(
        sample_rate=smp_freq,
        frame_ms=framesize * 1000.0 / smp_freq,
        shift_ms=frameshift * 1000.0 / smp_freq,
        preemph=pre, lifter=lifter, fbank_num=fbank,
        delta_win=delwin, accel_win=accwin,
        silfloor_db=silfloor, escale=escale,
        hipass_hz=hipass, lopass_hz=lopass,
        energy_normalize=bool(enormal), raw_e=bool(raw_e),
        zmeanframe=bool(zmeanframe), use_power=bool(usepower),
    )
    return cfg


def _apply_param_type(cfg: FrontendConfig, ptype: int, vec_size: int):
    base = F_BASE[ptype & 0x3F] if (ptype & 0x3F) < len(F_BASE) else "MFCC"
    cfg.feature_type = base
    cfg.use_energy = bool(ptype & F_ENERGY)
    cfg.absesup = bool(ptype & F_ENERGY_SUP)
    cfg.use_delta = bool(ptype & F_DELTA)
    cfg.use_accel = bool(ptype & F_ACCL)
    cfg.cmn = bool(ptype & F_CEPNORM)
    cfg.use_c0 = bool(ptype & F_ZEROTH)
    # derive cepstral dim from the AM vector length
    nblock = 1 + int(cfg.use_delta) + int(cfg.use_accel)
    base_dim = (vec_size + (1 if cfg.absesup else 0)) // nblock
    cfg.mfcc_dim = base_dim - int(cfg.use_c0) - int(cfg.use_energy)


def read_binhmm(path: str) -> Tuple[HMMSet, Optional[FrontendConfig]]:
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\x1f\x8b":
        data = gzip.decompress(data)
    r = _BE(data)
    head = r.cstr()
    para: Optional[FrontendConfig] = None
    var_inv = False
    mpdf_macro = False
    if head == "JBINHMM\n":
        pass
    elif head == "JBINHMMV2":
        quals = r.cstr()
        emp = "P" in quals
        var_inv = "V" in quals
        mpdf_macro = "M" in quals
        if emp:
            para = _para_to_frontend(r)
    else:
        raise ValueError("not a Julius binary HMM file (JBINHMM/JBINHMMV2)")

    nstream = r.i16()
    _vsize = [r.i16() for _ in range(MAXSTREAMNUM)]
    vec_size = r.i16()
    _cov = r.i16()
    _dur = r.i16()
    param_type = r.i16()
    if nstream > 1:
        raise NotImplementedError("multi-stream binhmm not supported")

    is_tmix = r.u8()
    _maxmix = r.i32()

    # transitions
    tr: List[np.ndarray] = []
    for _ in range(r.u32()):
        r.cstr()
        sn = r.i16()
        tr.append(r.f32arr(sn * sn).reshape(sn, sn))
    # variances
    vr: List[np.ndarray] = []
    for _ in range(r.u32()):
        r.cstr()
        ln = r.i16()
        vr.append(r.f32arr(ln))
    # densities
    means: List[np.ndarray] = []
    ivars: List[np.ndarray] = []
    gconst: List[float] = []
    n_dens = r.u32()
    for _ in range(n_dens):
        r.cstr()
        ml = r.i16()
        means.append(r.f32arr(ml))
        vid = r.u32()
        v = vr[vid]
        ivars.append(v if var_inv else 1.0 / np.maximum(v, 1e-20))
        gconst.append(r.f32())
    # tied-mixture codebooks
    books: List[np.ndarray] = []
    if is_tmix:
        for _ in range(r.u32()):
            r.cstr()
            num = r.i32()
            books.append(r.u32arr(num))

    def read_pdf_sub():
        mix = r.i16()
        if mix == -1:
            bid = r.u32()
            ids = books[bid]
            w = r.f32arr(len(ids))
        else:
            ids = r.u32arr(mix)
            w = r.f32arr(mix)
        return ids, w

    mpdfs: List[Tuple[np.ndarray, np.ndarray]] = []
    if mpdf_macro:
        for _ in range(r.u32()):
            r.cstr()
            r.i16()     # stream_id
            mpdfs.append(read_pdf_sub())

    # states
    n_state = r.u32()
    st_mix: List[List[Tuple[int, float]]] = []
    for _ in range(n_state):
        r.cstr()
        if mpdf_macro:
            mid = r.u32()
            ids, w = mpdfs[mid]
        else:
            ids, w = read_pdf_sub()
        # stored weights are natural-log bweight values
        # (rdhmmdef_mpdf.c:189); LOG_ZERO marks an absent mixture
        mixes = [(int(g), float(wi))
                 for g, wi in zip(ids, w)
                 if g < n_dens and wi > -5.0e5]
        st_mix.append(mixes)
    # models
    n_model = r.u32()
    names: List[str] = []
    hmms: List[Tuple[List[int], np.ndarray]] = []
    for _ in range(n_model):
        name = r.cstr()
        sn = r.i16()
        sids = r.u32arr(sn)
        tid = r.u32()
        emitting = [int(s) for s in sids if s < n_state]
        # stored transitions are log10 (rdhmmdef_trans.c:151 domain,
        # LOG_ZERO = -1000000 for prob 0); convert to our natural log
        a10 = tr[tid].astype(np.float64)
        ln = np.where(a10 > -5.0e5, a10 * np.log(10.0),
                      LOG_ZERO).astype(np.float32)
        names.append(name)
        hmms.append((emitting, ln))

    # flatten into HMMSet
    S = n_state
    M = max(1, max(len(m) for m in st_mix))
    G = n_dens
    D = means[0].shape[0] if means else 0
    P = n_model
    NS = max(len(h[0]) for h in hmms)
    state_mix = np.full((S, M), -1, dtype=np.int32)
    state_lw = np.full((S, M), LOG_ZERO, dtype=np.float32)
    for i, mixes in enumerate(st_mix):
        for j, (g, lw) in enumerate(mixes):
            state_mix[i, j] = g
            state_lw[i, j] = lw
    phone_states = np.full((P, NS), -1, dtype=np.int32)
    phone_ns = np.zeros(P, dtype=np.int32)
    phone_trans = np.full((P, NS + 2, NS + 2), LOG_ZERO, dtype=np.float32)
    for i, (sids, ln) in enumerate(hmms):
        ns = len(sids)
        phone_ns[i] = ns
        phone_states[i, :ns] = sids
        phone_trans[i, : ns + 2, : ns + 2] = ln

    hmmset = HMMSet(
        means=np.stack(means).astype(np.float32),
        ivars=np.stack(ivars).astype(np.float32),
        gconst=np.asarray(gconst, dtype=np.float32),
        state_mix=state_mix, state_lw=state_lw,
        state_sid=np.arange(S, dtype=np.int32),
        phone_states=phone_states, phone_ns=phone_ns,
        phone_trans=phone_trans,
        phone_names=names,
        phone_index={n: i for i, n in enumerate(names)},
        logical_map={},
        veclen=vec_size,
        names_are_triphone=any(("-" in n or "+" in n) for n in names),
    )
    if para is not None:
        _apply_param_type(para, param_type, vec_size)
    return hmmset, para


def _frontend_to_para(cfg: FrontendConfig) -> bytes:
    out = struct.pack(">h", VALUE_VERSION)
    out += struct.pack(">iiii",
                       int(1.0e7 / cfg.sample_rate), cfg.sample_rate,
                       cfg.frame_size, cfg.frame_shift)
    out += struct.pack(">f", cfg.preemph)
    out += struct.pack(">iiii", cfg.lifter, cfg.fbank_num,
                       cfg.delta_win, cfg.accel_win)
    out += struct.pack(">ff", cfg.silfloor_db, cfg.escale)
    out += struct.pack(">iiiiii", cfg.hipass_hz, cfg.lopass_hz,
                       int(cfg.energy_normalize), int(cfg.raw_e),
                       int(cfg.zmeanframe), int(cfg.use_power))
    return out


def _param_type_code(cfg: FrontendConfig) -> int:
    base = (cfg.feature_type or "MFCC").split("_")[0].upper()
    code = F_BASE.index(base) if base in F_BASE else F_BASE.index("MFCC")
    if cfg.use_energy:
        code |= F_ENERGY
    if cfg.absesup:
        code |= F_ENERGY_SUP
    if cfg.use_delta:
        code |= F_DELTA
    if cfg.use_accel:
        code |= F_ACCL
    if cfg.cmn:
        code |= F_CEPNORM
    if cfg.use_c0:
        code |= F_ZEROTH
    return code


def write_binhmm(path: str, hmm: HMMSet,
                 para: Optional[FrontendConfig] = None) -> None:
    """Write a V2 binhmm (mkbinhmm equivalent).  Variances are written
    inversed (qualifier _V) since HMMSet stores 1/var; macro names are
    not preserved (the flattened model has no macro identity — the
    reference reads anonymous entries fine)."""
    out = bytearray()
    quals = ""
    if para is not None:
        quals += "_P"
    quals += "_V"
    out += b"JBINHMMV2\x00" + quals.encode() + b"\x00"
    if para is not None:
        out += _frontend_to_para(para)
    # opt
    out += struct.pack(">h", 1)
    vsize = [0] * MAXSTREAMNUM
    vsize[0] = hmm.dim
    out += struct.pack(">" + "h" * MAXSTREAMNUM, *vsize)
    ptype = _param_type_code(para) if para is not None else 0x0006
    out += struct.pack(">hhhh", hmm.dim, 1, 0, ptype)  # cov=1(diag), dur=0
    # type
    out += struct.pack(">Bi", 0, hmm.max_mix)
    # trans: one per phone.  The reference stores the *in-memory* values
    # (rdhmmdef_trans.c:151 converts probs to log10 with LOG_ZERO for
    # zero at hmmdefs load; write_binhmm.c dumps them as-is), so convert
    # our natural-log transitions to log10 and clamp to the reference's
    # LOG_ZERO (-1000000, stddefs.h:171).
    P = hmm.n_phones
    out += struct.pack(">I", P)
    for p in range(P):
        ns = int(hmm.phone_ns[p]) + 2
        ln = hmm.phone_trans[p][:ns, :ns].astype(np.float64)
        a10 = np.where(ln > -5.0e5, ln / np.log(10.0), REF_LOG_ZERO)
        out += b"\x00" + struct.pack(">h", ns)
        out += a10.astype(">f4").tobytes()
    # var: one per gaussian (inversed)
    G = hmm.n_gauss
    out += struct.pack(">I", G)
    for g in range(G):
        out += b"\x00" + struct.pack(">h", hmm.dim)
        out += hmm.ivars[g].astype(">f4").tobytes()
    # dens
    out += struct.pack(">I", G)
    for g in range(G):
        out += b"\x00" + struct.pack(">h", hmm.dim)
        out += hmm.means[g].astype(">f4").tobytes()
        out += struct.pack(">If", g, float(hmm.gconst[g]))
    # states (inline pdfs, single stream)
    S = hmm.n_states
    out += struct.pack(">I", S)
    for s in range(S):
        mixes = [(int(g), float(w)) for g, w in
                 zip(hmm.state_mix[s], hmm.state_lw[s]) if g >= 0]
        # mixture weights are stored in natural log (the in-memory
        # bweight domain, rdhmmdef_mpdf.c:189)
        out += b"\x00" + struct.pack(">h", len(mixes))
        for g, _ in mixes:
            out += struct.pack(">I", g)
        for _, w in mixes:
            out += struct.pack(">f", float(w) if w > -5.0e5
                               else REF_LOG_ZERO)
    # models
    out += struct.pack(">I", P)
    for p in range(P):
        ns = int(hmm.phone_ns[p])
        out += hmm.phone_names[p].encode("latin-1") + b"\x00"
        out += struct.pack(">h", ns + 2)
        out += struct.pack(">I", 0xFFFFFFFF)
        for j in range(ns):
            out += struct.pack(">I", int(hmm.phone_states[p, j]))
        out += struct.pack(">I", 0xFFFFFFFF)
        out += struct.pack(">I", p)
    with open(path, "wb") as f:
        f.write(bytes(out))
