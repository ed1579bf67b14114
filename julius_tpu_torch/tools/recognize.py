"""Batch recognizer CLI, the `julius` application (PyTorch/CUDA).

Port of `julius_tpu/tools/recognize.py` (reference `julius/main.c`,
`recogloop.c`, `output_stdout.c`; `output_file.c` for -outfile,
`record.c` for -record, `charconv.c` for -charconv).  Usage:

    python -m julius_tpu_torch.tools.recognize -C file.jconf audio1.wav ...
    python -m julius_tpu_torch.tools.recognize -h am.binhmm -v dict \\
        -d lm.bingram -input mfcfile -filelist list.txt

Files are decoded on the card in batches of -batchsize (`main(argv,
device="cpu")` runs on the CPU); -48 decimates 48 kHz files to 16 kHz
first (adin/native_wrapper.py NativeDecimator).  Live input (-input
mic/alsa/pulseaudio/oss, or fake:<file> to replay a file through the
same path) is captured, segmented by the VAD and decoded segment by
segment through streaming.py's StreamSession, each printed as a `live
segment N` block.  -walign/-palign/-salign print the forced alignments
of each result.  -plugindir loads Python plugins (plugins.py: startup,
result receivers, feature and audio post-processing); -check runs the
model checks of tools/checkmodel.py on the first engine.
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from julius_tpu_torch.adin.native_wrapper import (NativeDecimator,
                                                  make_capture)
from julius_tpu_torch.engine import Result
from julius_tpu_torch.frontend.stream import vad_config_from
from julius_tpu_torch.fusion import create_engines
from julius_tpu_torch.io.htk_param import (HTKParam, read_htk_param,
                                          write_htk_param)
from julius_tpu_torch.io.wav import read_audio, write_wav
from julius_tpu_torch.jconf import parse_jconf
from julius_tpu_torch.plugins import PluginManager
from julius_tpu_torch.search.graphout import graph_to_text
from julius_tpu_torch.streaming import StreamSession
from julius_tpu_torch.tools.checkmodel import check_engine
from julius_tpu_torch.utils.jlog import (DEFAULT as LOG_DEFAULT, LogLevel,
                                         jlog, set_log_level, set_log_output)

LIVE_SOURCES = ("mic", "alsa", "pulseaudio", "oss")


def format_result(r: Result, sr_name: str = "_default",
                  separate_score: bool = False) -> str:
    """Reference output_stdout.c result block format."""
    lines = []
    if not r.valid:
        lines.append("<input rejected by decoder>")
        return "\n".join(lines)
    nbest = r.nbest or [r]
    for i, h in enumerate(nbest, 1):
        text = " ".join(t for t in (h.texts or h.words) if t)
        lines.append(f"sentence{i}: {text}")
        lines.append(f"wseq{i}: {' '.join(h.words)}")
        if h.cm is not None:
            lines.append(
                f"cmscore{i}: " + " ".join(f"{c:.3f}" for c in h.cm))
        if separate_score:
            lines.append(f"score{i}: {h.score:.6f} "
                         f"(AM: {h.am_score:.6f} LM: {h.lm_score:.6f})")
        else:
            lines.append(f"score{i}: {h.score:.6f}")
    return "\n".join(lines)


def result_block(eng, r: Result, separate_score: bool = False) -> str:
    """Full per-utterance output block: N-best + alignments + lattice +
    confusion network (the CALLBACK_RESULT payload of output_stdout.c)."""
    parts = [format_result(r, separate_score=separate_score)]
    if r.alignment is not None:
        al = r.alignment
        if eng.search_cfg.align_word:
            parts.append("=== word alignment ===")
            parts.extend(f"[{w['begin']:4d} {w['end']:4d}] {w['word']}"
                         for w in al.words)
        if eng.search_cfg.align_phoneme:
            parts.append("=== phoneme alignment ===")
            parts.extend(f"[{p['begin']:4d} {p['end']:4d}] {p['phone']}"
                         for p in al.phones)
        if eng.search_cfg.align_state:
            parts.append("=== state alignment ===")
            parts.extend(
                f"[{s['begin']:4d} {s['end']:4d}] {s['phone']}.s{s['state']}"
                for s in al.states)
    if eng.search_cfg.graph_out and r.graph is not None:
        parts.append("--- begin wordgraph data ---")
        parts.append(graph_to_text(r.graph, eng.voca.names).rstrip("\n"))
        parts.append("--- end wordgraph data ---")
    if eng.search_cfg.confnet_out and r.confnet is not None:
        parts.append("--- begin confusion network ---")
        for c in r.confnet:
            parts.append(" ".join(
                f"({eng.voca.names[w]}:{p:.3f})"
                for w, p in zip(c.words, c.probs)))
        parts.append("--- end confusion network ---")
    return "\n".join(parts)


class OutputSink:
    """stdout writer with optional charset conversion (-charconv; reference
    julius/charconv.c) plus optional per-input .out files (-outfile;
    reference julius/output_file.c)."""

    def __init__(self, charconv: Optional[tuple] = None,
                 outfile: bool = False):
        self.charconv = charconv
        self.outfile = outfile
        self._file = None

    def open_for(self, input_path: str) -> None:
        if self.outfile:
            out = os.path.splitext(input_path)[0] + ".out"
            self._file = open(out, "w", encoding=(
                self.charconv[1] if self.charconv else "utf-8"),
                errors="replace")

    def close_input(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def emit(self, text: str) -> None:
        if self.charconv:
            data = text.encode(self.charconv[1], errors="replace")
            sys.stdout.flush()
            sys.stdout.buffer.write(data + b"\n")
            sys.stdout.buffer.flush()
        else:
            print(text)
        if self._file is not None:
            self._file.write(text + "\n")


def record_utterance(record_dir: str, wave: np.ndarray, rate: int) -> str:
    """-record: dump the decoded segment as a timestamped wav (reference
    julius/record.c naming YYYY.MMDD.HHMMSS.wav + uniquifier)."""
    os.makedirs(record_dir, exist_ok=True)
    stamp = time.strftime("%Y.%m%d.%H%M%S")
    path = os.path.join(record_dir, stamp + ".wav")
    k = 0
    while os.path.exists(path):
        k += 1
        path = os.path.join(record_dir, f"{stamp}.{k}.wav")
    write_wav(path, wave.astype(np.int16), rate)
    return path


def collect_inputs(cfg, extra: List[str]) -> List[str]:
    files = [a for a in extra if not a.startswith("-")]
    if cfg.filelist_path:
        with open(cfg.filelist_path) as f:
            files.extend(s.strip() for s in f if s.strip())
    return files


def split_argv(argv: List[str]):
    """Split positional input files from options (options consume their
    values) -> (options, files)."""
    known_novalue = {"-1pass", "-walign", "-palign", "-salign", "-lattice",
                     "-nolattice", "-confnet", "-noconfnet", "-mbr",
                     "-nombr", "-cvn", "-cmnstatic", "-cmnnoupdate",
                     "-enormal", "-noenormal", "-rawe", "-norawe",
                     "-zmeanframe", "-nozmeanframe", "-usepower", "-iwsp",
                     "-cutsilence", "-nocutsilence", "-quiet", "-debug",
                     "-outfile", "-module", "-force_ccd", "-no_ccd",
                     "-separatescore", "-progout", "-nolog", "-demo",
                     "-nocharconv"}
    opts, files = [], []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("-"):
            opts.append(a)
            if a == "-SR":
                opts.extend(argv[i + 1: i + 4])
                i += 3
            elif a in ("-lmp", "-lmp2", "-vtln", "-charconv"):
                k = 3 if a == "-vtln" else 2
                opts.extend(argv[i + 1: i + 1 + k])
                i += k
            elif a not in known_novalue and i + 1 < len(argv):
                opts.append(argv[i + 1])
                i += 1
        else:
            files.append(a)
        i += 1
    return opts, files


def _load_batch(paths: List[str], mfc_mode: bool, cfg, rate: int,
                plugins: Optional[PluginManager] = None):
    """Input files -> ([B, T, D] features or [B, L] waveforms, [B]
    lengths), zero-padded, on the host; the plugins' fvin / adin
    post-processing applied to each input."""
    if mfc_mode:
        # feature-file input (reference -input mfcfile, m_adin.c)
        datas = [read_htk_param(p).data for p in paths]
        if plugins is not None:
            datas = [plugins.fvin_postprocess(d) for d in datas]
        batch = np.zeros((len(datas), max(d.shape[0] for d in datas),
                          datas[0].shape[1]), dtype=np.float32)
    else:
        datas = [read_audio(p) for p in paths]
        if cfg.ds48:
            # -48: 48 kHz input decimated to 16 kHz (reference
            # ds48to16.c; a Kaiser-windowed FIR here), one decimator
            # through the batch as the reference runs it
            dec = NativeDecimator(factor=3)
            datas = [dec.feed(w) for w in datas]
        if cfg.level_coef != 1.0:
            datas = [w * cfg.level_coef for w in datas]
        if cfg.zmean:
            # -zmean: whole-utterance DC offset removal (zmean.c)
            datas = [w - float(np.mean(w)) for w in datas]
        if plugins is not None:
            datas = [plugins.adin_postprocess(w) for w in datas]
        batch = np.zeros((len(datas), max(len(w) for w in datas)),
                         dtype=np.float32)
        if cfg.record_dir:
            for w in datas:
                p = record_utterance(cfg.record_dir, w, rate)
                jlog(LogLevel.STAT, f"recorded to {p}")
    lens = np.zeros(len(datas), dtype=np.int32)
    for j, d in enumerate(datas):
        batch[j, : d.shape[0]] = d
        lens[j] = d.shape[0]
    return batch, lens


def _write_outprob(eng, batch, lens, mfc_mode: bool, prefix: str,
                   first: int) -> None:
    """-outprobout: each input's senone scores as an HTK USER parameter
    file <prefix>.<index>.prob (reference recogmain.c:1225-1242)."""
    if mfc_mode:
        feats = batch
    else:
        with torch.no_grad():
            feats = eng._features(
                torch.as_tensor(batch, device=eng.device),
                torch.as_tensor(lens, device=eng.device))[0]
    rows = eng.compute_outprob(feats)
    for j in range(len(lens)):
        out = f"{prefix}.{first + j:04d}.prob"
        write_htk_param(out, HTKParam(
            data=rows[j, : lens[j]].astype(np.float32),
            samp_period=100000, kind="USER"))
        print(f"outprob written: {out}")


def _live_input(cfg, eng) -> None:
    """Live audio input (reference -input mic, m_adin.c device
    selection): capture -> VAD segmentation -> streaming decode, each
    finished segment printed as `live segment N`."""
    sink = OutputSink(charconv=cfg.charconv, outfile=cfg.outfile)
    rate = eng.fe_cfg.sample_rate
    cap = make_capture(cfg.input_source, rate=rate)
    sess = StreamSession(eng, vad=vad_config_from(cfg, rate),
                         progout=cfg.progout)
    jlog(LogLevel.STAT, "listening (Ctrl-C to stop)")
    n_out = 0

    def emit(results):
        nonlocal n_out
        for r in results:
            sink.emit(f"\ninput: live segment {n_out}")
            sink.emit(result_block(eng, r,
                                   separate_score=cfg.separatescore))
            n_out += 1

    try:
        while True:
            chunk = cap.read(4000)
            if chunk is None:
                break
            emit(sess.feed(chunk))
    except KeyboardInterrupt:
        pass
    emit(sess.close())
    cap.close()


def main(argv=None, device="cuda") -> int:
    argv = argv if argv is not None else sys.argv[1:]
    opts, files = split_argv(argv)
    cfg = parse_jconf(opts)
    log_fh = None
    if cfg.logfile:
        log_fh = open(cfg.logfile, "w", encoding="utf-8")
        set_log_output(log_fh)
    elif cfg.quiet:
        set_log_level(LogLevel.WARNING)
    try:
        engines = create_engines(cfg, device=device)
        if cfg.check_modes:
            # -version/-setting/-check: engine info dump + model checkers
            # (reference m_info.c print_engine_info, hmm_check.c,
            # wchmm_check.c)
            for mode in cfg.check_modes:
                if mode == "info":
                    print(engines[0].describe())
                else:
                    try:
                        check_engine(engines[0], mode)
                    except Exception as e:
                        jlog(LogLevel.WARNING, f"-check {mode}: {e}")
            if not files and cfg.input_source == "file":
                return 0
        plugins = None
        if cfg.plugin_dirs:
            plugins = PluginManager()
            for d in cfg.plugin_dirs:
                plugins.load_dir(d)
            plugins.startup(engines)
        source = cfg.input_source or ""
        if source in LIVE_SOURCES or source.startswith("fake:"):
            _live_input(cfg, engines[0])
            return 0
        files = collect_inputs(cfg, files)
        if not files:
            jlog(LogLevel.ERROR, "no input files (give paths or -filelist)")
            return 1
        sink = OutputSink(charconv=cfg.charconv, outfile=cfg.outfile)
        B = max(1, cfg.batch_size)
        mfc_mode = cfg.input_source in ("mfcfile", "htkparam")
        rate = engines[0].fe_cfg.sample_rate
        for ofs in range(0, len(files), B):
            chunk = files[ofs: ofs + B]
            batch, lens = _load_batch(chunk, mfc_mode, cfg, rate, plugins)
            for eng in engines:
                if mfc_mode:
                    results = eng.decode_features(batch, lens)
                else:
                    results = eng.recognize_batch(batch, lens)
                if cfg.outprob_out:
                    _write_outprob(eng, batch, lens, mfc_mode,
                                   cfg.outprob_out, ofs)
                for path, r in zip(chunk, results):
                    sink.open_for(path)
                    sink.emit(f"\ninput: {path}")
                    sink.emit(result_block(
                        eng, r, separate_score=cfg.separatescore))
                    sink.close_input()
        return 0
    finally:
        if log_fh is not None:
            set_log_output(LOG_DEFAULT)
            log_fh.close()


if __name__ == "__main__":
    sys.exit(main())
