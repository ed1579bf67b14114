"""Batched HTK-compatible feature extraction (torch).

Port of `julius_tpu/frontend/mfcc.py`, which replaces the reference's
per-frame C pipeline (libsent/src/wav2mfcc/mfcc-core.c WMP_calc +
wav2mfcc-buffer.c Wav2MFCC) with a whole-utterance, whole-batch tensor
program: framing is a strided view, the FFT is `torch.fft.rfft`, the mel
filterbank and DCT are float32 matrix products, and delta/accel are
fixed-width regressions.  Numerics follow the reference exactly (same
mel spacing via the loChan/loWt construction mfcc-core.c:229, same
DCT/lifter constants, same energy normalisation NormaliseLogE and
CMN/MVN semantics from wav2mfcc-buffer.c).  The constant tables are host
numpy (`build_tables`, copied); variable utterance lengths are handled
with a frame mask.

The products must run in full float32: the engine turns TF32 off for
CUDA matrix products (engine.py), so the mel and DCT products round as
the reference's `Precision.HIGHEST` ones do.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from julius_tpu_torch.config import FrontendConfig
from julius_tpu_torch.utils.device import full_f32_matmul


# ---------------------------------------------------------------------------
# Host-side constant tables
# ---------------------------------------------------------------------------

@dataclass
class FrontendTables:
    """Precomputed constants (the MFCCWork equivalent)."""

    window: np.ndarray     # [frame_size] hamming
    mel_w: np.ndarray      # [fft//2, fbank_num] filterbank weights
    dct_m: np.ndarray      # [fbank_num, mfcc_dim] DCT basis * sqrt(2/N)
    lifter: np.ndarray     # [mfcc_dim]
    c0_scale: float        # sqrt(2/N)
    cfg: FrontendConfig


def build_tables(cfg: FrontendConfig) -> FrontendTables:
    fs = cfg.frame_size
    nfft = cfg.fft_size
    nv2 = nfft // 2
    nchan = cfg.fbank_num

    window = (0.54 - 0.46 * np.cos(
        2.0 * np.pi * np.arange(fs) / (fs - 1))).astype(np.float32)

    # mel filterbank - reference InitFBank (mfcc-core.c:229): 1-based fft
    # "channel" k corresponds to fft bin k-1; fres converts bin to f/700.
    smp_period = 1.0e7 / cfg.sample_rate           # in 100ns units
    fres = 1.0e7 / (smp_period * nfft * 700.0)

    def mel_of(k):
        return 1127.0 * np.log(1.0 + (k - 1) * fres)

    klo, khi = 2, nv2
    mlo = 0.0
    mhi = mel_of(nv2 + 1)
    if cfg.lopass_hz >= 0:
        mlo = 1127.0 * np.log(1.0 + cfg.lopass_hz / 700.0)
        klo = int(cfg.lopass_hz * smp_period * 1.0e-7 * nfft + 2.5)
        klo = max(klo, 2)
    if cfg.hipass_hz >= 0:
        mhi = 1127.0 * np.log(1.0 + cfg.hipass_hz / 700.0)
        khi = int(cfg.hipass_hz * smp_period * 1.0e-7 * nfft + 0.5)
        khi = min(khi, nv2)

    maxchan = nchan + 1
    cf = np.zeros(maxchan + 1)
    for chan in range(1, maxchan + 1):
        cf[chan] = (chan / maxchan) * (mhi - mlo) + mlo
    if cfg.vtln_alpha != 1.0:
        cf = _vtln_warp(cf, cfg, mlo, mhi, maxchan)

    mel_w = np.zeros((nv2, nchan), dtype=np.float32)
    chan = 1
    for k in range(1, nv2 + 1):
        if k < klo or k > khi:
            continue
        melk = mel_of(k)
        while chan <= maxchan and cf[chan] < melk:
            chan += 1
        lo = chan - 1
        if lo > 0:
            lowt = (cf[lo + 1] - melk) / (cf[lo + 1] - cf[lo])
        else:
            lowt = (cf[1] - melk) / (cf[1] - mlo)
        # bin index in fft array is k-1; fbank channels are 1-based
        if lo > 0:
            mel_w[k - 1, lo - 1] += lowt
        if lo < nchan:
            mel_w[k - 1, lo] += 1.0 - lowt

    # DCT basis (reference MakeMFCC)
    sqrt2var = math.sqrt(2.0 / nchan)
    j = np.arange(1, nchan + 1)
    i = np.arange(1, cfg.mfcc_dim + 1)
    dct_m = (np.cos(np.pi * np.outer(j - 0.5, i) / nchan)
             * sqrt2var).astype(np.float32)

    lifter = (1.0 + (cfg.lifter / 2.0) * np.sin(
        np.pi * np.arange(1, cfg.mfcc_dim + 1) / cfg.lifter)).astype(np.float32)

    return FrontendTables(window=window, mel_w=mel_w, dct_m=dct_m,
                          lifter=lifter, c0_scale=sqrt2var, cfg=cfg)


def _vtln_warp(cf, cfg, mlo, mhi, maxchan):
    """VTLN piecewise-linear warp of filterbank centres
    (reference VTLN_recreate_fbank_cf mfcc-core.c:177)."""
    minf = 700.0 * (np.exp(mlo / 1127.0) - 1.0)
    maxf = 700.0 * (np.exp(mhi / 1127.0) - 1.0)
    upper = cfg.vtln_upper if cfg.vtln_upper > 0 else maxf * 0.9
    scale = 1.0 / cfg.vtln_alpha
    cu = upper * 2 / (1 + scale)
    cl = cfg.vtln_lower * 2 / (1 + scale)
    au = (maxf - cu * scale) / (maxf - cu)
    al = (cl * scale - minf) / (cl - minf)
    out = cf.copy()
    for chan in range(1, maxchan + 1):
        f = 700.0 * (np.exp(cf[chan] / 1127.0) - 1.0)
        if f > cu:
            fn = au * (f - cu) + scale * cu
        elif f < cl:
            fn = al * (f - minf) + minf
        else:
            fn = scale * f
        out[chan] = 1127.0 * np.log(1.0 + fn / 700.0)
    return out


def num_frames(n_samples: int, cfg: FrontendConfig) -> int:
    if n_samples < cfg.frame_size:
        return 0
    return (n_samples - cfg.frame_size) // cfg.frame_shift + 1


# ---------------------------------------------------------------------------
# Device pipeline
# ---------------------------------------------------------------------------

def _frame_signal(wave: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """[B, L] -> [B, T, frame_size] strided windows (a view)."""
    B, L = wave.shape
    if num_frames(L, cfg) == 0:
        return wave.new_zeros((B, 0, cfg.frame_size))
    return wave.unfold(1, cfg.frame_size, cfg.frame_shift)


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=like.device)


def _log_floor(x: torch.Tensor, floor: float) -> torch.Tensor:
    return torch.log(x.clamp(min=floor))


def extract_basic(
    wave: torch.Tensor,
    tables: FrontendTables,
    noise_spectrum: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Static features for a batch of waveforms: [B, L] -> [B, T, baselen].

    Layout per frame: [cepstra (mfcc_dim) | c0? | energy?], matching the
    reference WMP_calc output ordering (mfcc-core.c:716-722)."""
    cfg = tables.cfg
    frames = _frame_signal(wave, cfg)                 # [B, T, F]

    if cfg.zmeanframe:
        frames = frames - frames.mean(dim=-1, keepdim=True)

    raw_energy = _log_floor((frames * frames).sum(dim=-1), 1e-10)

    # pre-emphasis within frame (reference PreEmphasise: first sample
    # scaled by (1 - k), rest get the running difference)
    k = cfg.preemph
    pre = torch.cat([frames[..., :1] * (1.0 - k),
                     frames[..., 1:] - k * frames[..., :-1]], dim=-1)

    windowed = pre * _const(tables.window, wave)
    win_energy = _log_floor((windowed * windowed).sum(dim=-1), 1e-10)
    energy = raw_energy if cfg.raw_e else win_energy

    nfft = cfg.fft_size
    spec = torch.fft.rfft(windowed, n=nfft, dim=-1)   # [B, T, nfft/2+1]
    mag = spec.abs()[..., : nfft // 2]                # bins 0..nv2-1

    if noise_spectrum is not None or cfg.sscalc_frames > 0:
        # spectral subtraction (reference ss in MakeFBank / ss.c:111);
        # -sscalc estimates the noise power per utterance from the head
        # frames of the input itself (reference sscalc path)
        p2 = mag * mag
        if noise_spectrum is not None:
            np2 = noise_spectrum.to(mag)[: nfft // 2] ** 2
        else:
            np2 = p2[:, :cfg.sscalc_frames].mean(dim=1, keepdim=True)
        sub = p2 - cfg.ss_alpha * np2
        mag = torch.where(sub < 0, cfg.ss_floor * mag,
                          torch.sqrt(sub.clamp(min=0)))

    if cfg.use_power:
        mag = mag * mag

    with full_f32_matmul():
        fbank = torch.matmul(mag, _const(tables.mel_w, wave))  # [B, T, nchan]

    base = (cfg.feature_type or "MFCC").split("_")[0].upper()
    if base in ("FBANK", "MELSPEC"):
        # FBANK/MELSPEC use all channels directly (reference fbank_only)
        feats = _log_floor(fbank, 1.0) if base == "FBANK" else fbank
        parts = [feats]
        if cfg.use_energy:
            parts.append(energy[..., None])
        return torch.cat(parts, dim=-1)

    logfb = _log_floor(fbank, 1.0)
    with full_f32_matmul():
        cep = torch.matmul(logfb, _const(tables.dct_m, wave))  # [B, T, mfcc]
    cep = cep * _const(tables.lifter, wave)
    parts = [cep]
    if cfg.use_c0:
        parts.append(logfb.sum(dim=-1, keepdim=True) * tables.c0_scale)
    if cfg.use_energy:
        parts.append(energy[..., None])
    return torch.cat(parts, dim=-1)


def _normalise_log_energy(feats: torch.Tensor, mask: torch.Tensor,
                          cfg: FrontendConfig) -> torch.Tensor:
    """Reference NormaliseLogE (wav2mfcc-buffer.c:110): floor at
    max - silFloor*ln10/10, rescale to 1.0 - (max - E) * escale."""
    eidx = cfg.base_dim - 1
    e = feats[..., eidx]
    emax = torch.where(mask, e, float("-inf")).amax(dim=-1, keepdim=True)
    emin = emax - (cfg.silfloor_db * math.log(10.0)) / 10.0
    e = torch.maximum(e, emin)
    e = 1.0 - (emax - e) * cfg.escale
    out = feats.clone()
    out[..., eidx] = e
    return out


def _delta_block(x: torch.Tensor, mask: torch.Tensor,
                 win: int) -> torch.Tensor:
    """HTK delta regression over time with edge replication
    (reference Delta wav2mfcc-buffer.c / WMP_deltabuf_calc).

    x: [B, T, D]; mask: [B, T] valid-frame mask.  Edge replication must
    respect per-utterance length, so indices are clamped to [0, len-1]."""
    B, T, D = x.shape
    lengths = mask.to(torch.int64).sum(dim=-1)                  # [B]
    t = torch.arange(T, device=x.device)
    num = torch.zeros_like(x)
    denom = 2.0 * sum(th * th for th in range(1, win + 1))
    for th in range(1, win + 1):
        ip = torch.minimum(t + th, (lengths - 1).clamp(min=0)[:, None])
        im = (t - th).clamp(min=0)                              # [T]
        xp = x.gather(1, ip[..., None].expand(B, T, D))
        xm = x[:, im, :]
        num = num + th * (xp - xm)
    return num / denom


def extract_features(
    wave: torch.Tensor,
    lengths: torch.Tensor,
    tables: FrontendTables,
    cmn_mean: Optional[torch.Tensor] = None,
    cvn_var: Optional[torch.Tensor] = None,
    noise_spectrum: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full batched front end: [B, L] float32 waveforms (+ sample lengths
    [B]) -> ([B, T, veclen] features, [B, T] frame mask).

    Batch-mode CMN/CVN over each utterance's valid frames (reference
    Wav2MFCC wav2mfcc-buffer.c:57); pass cmn_mean/cvn_var for static
    normalisation (-cmnstatic semantics)."""
    cfg = tables.cfg
    feats = extract_basic(wave, tables, noise_spectrum)     # [B, T, base]
    B, T, _ = feats.shape
    lengths = torch.as_tensor(lengths, device=wave.device).to(torch.int64)
    nfr = torch.where(lengths >= cfg.frame_size,
                      torch.div(lengths - cfg.frame_size, cfg.frame_shift,
                                rounding_mode="floor") + 1, 0)
    mask = torch.arange(T, device=wave.device)[None, :] < nfr[:, None]

    if cfg.use_energy and cfg.energy_normalize and T > 0:
        feats = _normalise_log_energy(feats, mask, cfg)

    blocks = [feats]
    if cfg.use_delta:
        d = _delta_block(feats, mask, cfg.delta_win)
        if cfg.absesup:
            # static energy dropped; delta block keeps its own energy
            # (reference Delta's absesup slot shift)
            blocks = [feats[..., :-1], d]
        else:
            blocks = [feats, d]
        if cfg.use_accel:
            blocks.append(_delta_block(d, mask, cfg.accel_win))
    out = torch.cat(blocks, dim=-1)

    # CMN / CVN (reference CMN/MVN wav2mfcc-buffer.c): mean over static
    # cepstra (+c0) only; variance over the full vector.
    basedim = cfg.mfcc_dim + (1 if cfg.use_c0 else 0)
    fmask = mask[..., None]
    denom = fmask.sum(dim=1).clamp(min=1)                       # [B, 1]
    if cfg.cmn:
        if cmn_mean is not None:
            mean = cmn_mean.to(out)[None, None, :basedim]
        else:
            mean = (torch.where(fmask, out, 0.0).sum(dim=1, keepdim=True)
                    / denom[:, None])[..., :basedim]
        out = torch.cat([out[..., :basedim] - mean, out[..., basedim:]],
                        dim=-1)
    if cfg.cvn:
        if cvn_var is not None:
            sd = torch.sqrt(cvn_var.to(out).clamp(min=1e-10))[None, None, :]
        else:
            m = (torch.where(fmask, out, 0.0).sum(dim=1, keepdim=True)
                 / denom[:, None])
            v = (torch.where(fmask, (out - m) ** 2, 0.0)
                 .sum(dim=1, keepdim=True) / denom[:, None])
            sd = torch.sqrt(v.clamp(min=1e-10))
        out = out / sd
    out = torch.where(fmask, out, 0.0)
    return out, mask


def splice_frames(feats: torch.Tensor, mask: torch.Tensor,
                  context_len: int) -> torch.Tensor:
    """DNN input splicing: stack `context_len` consecutive frames centred
    on each frame, replicating edges within the valid region (reference
    RealTimeMFCC splice / calc_dnn input windowing).
    [B, T, D] -> [B, T, D * context_len]."""
    B, T, D = feats.shape
    half = context_len // 2
    lengths = mask.to(torch.int64).sum(dim=-1).clamp(min=1)
    t = torch.arange(T, device=feats.device)
    cols = []
    for off in range(-half, context_len - half):
        it = torch.minimum((t + off).clamp(min=0), (lengths - 1)[:, None])
        cols.append(feats.gather(1, it[..., None].expand(B, T, D)))
    return torch.cat(cols, dim=-1)
