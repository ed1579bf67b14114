"""Measure the reference C decoder's throughput on the flagship config.

BASELINE.md requires the reference's numbers to be measured locally (it
publishes none).  This tool exports the *same* synthetic flagship model
that bench.py decodes (tools/synth.py: 40ch FBANK_D_A front-end, 11-frame
splice, 5x2048 sigmoid DNN, ~2k senones, 5k-word 2-gram) into the
reference's own file formats — binhmm (write_binhmm, read by
libsent/src/hmminfo/read_binhmm.c), HTK dict, ARPA 2-gram
(ngram_read_arpa.c), dnnconf + npy weights (calc_dnn.c:225 load_npy:
little-endian f4, W stored row-major [out][in], bias (out,1)) — then
times `julius -input rawfile` end-to-end on 16 kHz wav files.

Usage:
    python -m julius_tpu_torch.tools.refbaseline --binary PATH \
        [--scale small] [--keep DIR]
(--binary defaults to $JULIUS_BIN.)  Prints one JSON line with the
measured xRT of the reference binary.

Port of `julius_tpu/tools/refbaseline.py`: the export writes the same
files with the port's writers (io/binhmm.py, io/arpa.py) from the port's
copy of the synth builders, byte for byte what the JAX package writes
for the same seed.  Nothing here runs on the card: the reference binary
is a CPU program.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np


def export_model(outdir: str, n_words: int = 5000, n_phones: int = 668,
                 hidden: int = 2048, n_layers: int = 5, seed: int = 0):
    """Write the synth flagship model in reference file formats.

    Returns a dict of file paths.  The exact arrays from
    tools/synth.make_* are used so the reference binary and our engine
    decode the same model."""
    from julius_tpu_torch.config import parse_feature_type
    from julius_tpu_torch.io.arpa import write_arpa
    from julius_tpu_torch.io.binhmm import write_binhmm
    from julius_tpu_torch.tools.synth import (make_dnn, make_hmmset,
                                              make_ngram, make_vocabulary)

    feat_dim = 120
    hmm = make_hmmset(n_phones=n_phones, dim=feat_dim, seed=seed)
    voca = make_vocabulary(hmm, n_words=n_words, seed=seed + 1)
    lm = make_ngram(voca, seed=seed + 2)
    dnn = make_dnn(dim_in=feat_dim * 11, hidden=hidden, n_layers=n_layers,
                   n_out=hmm.n_states, seed=seed + 3)

    fe = parse_feature_type("FBANK_D_A")
    fe.fbank_num = 40

    paths = {}
    hmmf = os.path.join(outdir, "flagship.binhmm")
    write_binhmm(hmmf, hmm, para=fe)
    paths["hmm"] = hmmf

    dictf = os.path.join(outdir, "flagship.dict")
    with open(dictf, "w") as f:
        for i, name in enumerate(voca.names):
            f.write(f"{name}\t[{name}]\t" + " ".join(voca.phones[i]) + "\n")
    paths["dict"] = dictf

    lmf = os.path.join(outdir, "flagship.arpa")
    write_arpa(lm, lmf)
    paths["lm"] = lmf

    # DNN weights: reference layout is row-major [out][in] (calc_dnn_fma.c
    # walks w by rows of length `in`); ours is [in][out] -> save transposed.
    for li, (w, b) in enumerate(zip(dnn.weights, dnn.biases), start=1):
        np.save(os.path.join(outdir, f"W{li}.npy"),
                np.ascontiguousarray(w.T.astype("<f4")))
        np.save(os.path.join(outdir, f"B{li}.npy"),
                b.reshape(-1, 1).astype("<f4"))
    np.save(os.path.join(outdir, "W_out.npy"),
            np.ascontiguousarray(dnn.output_w.T.astype("<f4")))
    np.save(os.path.join(outdir, "B_out.npy"),
            dnn.output_b.reshape(-1, 1).astype("<f4"))
    priorf = os.path.join(outdir, "prior.dnn")
    with open(priorf, "w") as f:
        for i, lp in enumerate(dnn.log_prior):
            f.write(f"{i} {10.0 ** float(lp):.8e}\n")

    n_out = dnn.output_w.shape[1]
    conf = [
        "feature_type FBANK_D_A",
        f"feature_options -htkconf {outdir}/htkconfig",
        "feature_len 120",
        "context_len 11",
        f"input_nodes {feat_dim * 11}",
        f"output_nodes {n_out}",
        f"hidden_nodes {hidden}",
        f"hidden_layers {n_layers}",
    ]
    for li in range(1, n_layers + 1):
        conf.append(f"W{li} {outdir}/W{li}.npy")
        conf.append(f"B{li} {outdir}/B{li}.npy")
    conf += [
        f"output_W {outdir}/W_out.npy",
        f"output_B {outdir}/B_out.npy",
        f"state_prior {priorf}",
        "state_prior_factor 1.0",
        f"num_threads {os.cpu_count()}",
    ]
    dnnconf = os.path.join(outdir, "flagship.dnnconf")
    with open(dnnconf, "w") as f:
        f.write("\n".join(conf) + "\n")
    paths["dnnconf"] = dnnconf

    with open(os.path.join(outdir, "htkconfig"), "w") as f:
        f.write("TARGETKIND = FBANK_D_A\n"
                "NUMCHANS = 40\n"
                "SOURCERATE = 625\n"
                "TARGETRATE = 100000.0\n"
                "WINDOWSIZE = 250000.0\n"
                "USEHAMMING = T\n"
                "PREEMCOEF = 0.97\n"
                "ENORMALISE = F\n"
                "ZMEANSOURCE = F\n")
    return paths


def write_wavs(outdir: str, n: int, audio_sec: float = 10.0,
               seed: int = 7) -> list:
    from julius_tpu_torch.io.wav import write_wav
    rng = np.random.default_rng(seed)
    files = []
    for i in range(n):
        w = (rng.standard_normal(int(16000 * audio_sec)) * 2000)
        p = os.path.join(outdir, f"utt{i:03d}.wav")
        write_wav(p, w.astype(np.int16), 16000)
        files.append(p)
    return files


def run_reference(binary: str, paths: dict, wavs: list, workdir: str,
                  beam: int = 0) -> float:
    """Run the reference on the wav list, return wall seconds."""
    listf = os.path.join(workdir, "wavlist.txt")
    with open(listf, "w") as f:
        f.write("\n".join(wavs) + "\n")
    cmd = [binary,
           "-h", paths["hmm"], "-v", paths["dict"],
           "-nlr", paths["lm"], "-dnnconf", paths["dnnconf"],
           "-input", "rawfile", "-filelist", listf,
           "-n", "1", "-output", "1"]
    if beam:
        cmd += ["-b", str(beam)]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=3600)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        sys.stderr.write(out.stderr[-4000:] + "\n")
        sys.stderr.write(out.stdout[-4000:] + "\n")
        raise RuntimeError(f"reference exited {out.returncode}")
    n_done = out.stdout.count("sentence1:")
    pass1 = out.stdout.count("pass1_best:")
    if n_done < len(wavs) and pass1 < len(wavs):
        sys.stderr.write(out.stdout[-3000:] + "\n")
        raise RuntimeError(
            f"reference decoded only {n_done}/{len(wavs)} inputs")
    return wall


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--binary", default=os.environ.get("JULIUS_BIN"),
                    help="the reference julius binary (default: "
                         "$JULIUS_BIN)")
    ap.add_argument("--scale", choices=["small", "flagship"],
                    default="flagship")
    ap.add_argument("--n-utts", type=int, default=8)
    ap.add_argument("--audio-sec", type=float, default=10.0)
    ap.add_argument("--keep", default=None,
                    help="export into this dir and keep files")
    args = ap.parse_args(argv)
    if not args.binary:
        ap.error("give --binary or set JULIUS_BIN")

    workdir = args.keep or tempfile.mkdtemp(prefix="refbaseline_")
    os.makedirs(workdir, exist_ok=True)
    if args.scale == "small":
        kw = dict(n_words=100, n_phones=32, hidden=64, n_layers=2)
    else:
        kw = dict(n_words=5000, n_phones=668, hidden=2048, n_layers=5)
    paths = export_model(workdir, **kw)
    wavs = write_wavs(workdir, args.n_utts, args.audio_sec)

    # two run sizes so model-load time cancels out of the estimate
    w_small = run_reference(args.binary, paths, wavs[:2], workdir)
    w_full = run_reference(args.binary, paths, wavs, workdir)
    decode_s = w_full - w_small
    audio_s = (len(wavs) - 2) * args.audio_sec
    xrt = audio_s / decode_s if decode_s > 0 else float("inf")
    print(json.dumps({
        "metric": "reference_decode_throughput",
        "value": round(xrt, 3),
        "unit": "audio_seconds_per_second (xRT, host CPU)",
        "detail": {
            "binary": args.binary, "scale": args.scale,
            "n_utts": len(wavs), "audio_sec_each": args.audio_sec,
            "wall_full_s": round(w_full, 2),
            "wall_2utt_s": round(w_small, 2),
            "cpus": os.cpu_count(),
        },
    }))


if __name__ == "__main__":
    main()
