"""Reference-parity harness: decode identical inputs with the reference
Julius binary and with julius_tpu_torch, compare transcripts and speed.

The reference publishes no benchmark numbers (BASELINE.md), so this tool
*measures* them locally: it synthesises models at a chosen scale, exports
them in the reference's own file formats (ascii hmmdefs
`libsent/src/hmminfo/rdhmmdef.c:262`, HTK dict `voca_load_htkdict.c:305`,
ARPA `ngram_read_arpa.c:540`, HTK param files `anlz/rdparam.c:198`,
dnnconf + npy `calc_dnn.c:225,528`), generates feature files from the
generative acoustic model itself (so the true transcript is known by
construction), then runs both decoders on the same .mfc files:

    python -m julius_tpu_torch.tools.refparity --ref /path/to/julius \
        [--workdir DIR] [--scale small|flagship|triphone] [--n-utts 20] \
        [--device cuda]

Feature files (not audio) are the exchange medium so the comparison
isolates the decoder: the reference consumes them with `-input mfcfile`
(m_options.c:326) exactly as the port consumes them with
Engine.decode_features.

Port of `julius_tpu/tools/refparity.py`: the model files are written by
the same code from the port's copy of the synth builders (byte for byte
the JAX package's export for the same seed), and the port's side of
each scenario decodes with `julius_tpu_torch` on the card (`device=`).
`--update-baseline PATH` writes the measured numbers into the JSON file
at PATH and nowhere else.
"""

from __future__ import annotations

import argparse
import io
import json
import math
import os
import re
import subprocess
import tempfile
import time

import numpy as np

from julius_tpu_torch.io.htk_param import HTKParam, write_htk_param

# ---------------------------------------------------------------------------
# Model synthesis (text formats the reference parses)
# ---------------------------------------------------------------------------


def gen_hmmdefs(phones, dim, n_states, n_mix, seed, kind="USER",
                sep=3.0, with_sid=False):
    """Ascii hmmdefs with well-separated diag-Gaussian mixtures.

    Same generative family as tests/fixtures.py; `sep` controls how far
    apart phone means are (decode difficulty)."""
    rng = np.random.default_rng(seed)
    out = io.StringIO()
    out.write(f"~o <VecSize> {dim} <{kind}> <DIAGC> <NULLD>\n")
    sid = 0
    for pi, p in enumerate(phones):
        out.write(f'~h "{p}"\n<BeginHMM>\n<NumStates> {n_states + 2}\n')
        for s in range(n_states):
            out.write(f"<State> {s + 2}\n")
            if with_sid:
                out.write(f"<SID> {sid}\n")
            sid += 1
            if n_mix > 1:
                out.write(f"<NumMixes> {n_mix}\n")
            base = rng.standard_normal(dim) * sep
            for m in range(n_mix):
                if n_mix > 1:
                    out.write(f"<Mixture> {m + 1} {1.0 / n_mix:.6f}\n")
                mean = base + 0.3 * rng.standard_normal(dim)
                var = 0.5 + 0.2 * rng.random(dim)
                out.write(f"<Mean> {dim}\n ")
                out.write(" ".join(f"{x:.6f}" for x in mean) + "\n")
                out.write(f"<Variance> {dim}\n ")
                out.write(" ".join(f"{x:.6f}" for x in var) + "\n")
        N = n_states + 2
        trans = np.zeros((N, N))
        trans[0, 1] = 1.0
        for s in range(1, N - 1):
            trans[s, s] = 0.6
            trans[s, s + 1] = 0.4
        out.write(f"<TransP> {N}\n")
        for r in range(N):
            out.write(" " + " ".join(f"{x:.6f}" for x in trans[r]) + "\n")
        out.write("<EndHMM>\n")
    return out.getvalue()


def gen_dict(phones, n_words, seed, min_phones=2, max_phones=5):
    """HTK dict text + the word list. <s>/</s> map to sil."""
    rng = np.random.default_rng(seed)
    usable = [p for p in phones if p != "sil"]
    lines = ["<s>\t[]\tsil", "</s>\t[]\tsil"]
    words = []
    for i in range(n_words):
        k = int(rng.integers(min_phones, max_phones + 1))
        seq = [usable[int(j)] for j in rng.integers(0, len(usable), size=k)]
        w = f"W{i:04d}"
        words.append((w, seq))
        lines.append(f"{w}\t[{w}]\t" + " ".join(seq))
    return "\n".join(lines) + "\n", words


def gen_arpa(word_names, seed, n_bi_per_word=8):
    """Random 2-gram ARPA over <s>, </s> and the word list."""
    rng = np.random.default_rng(seed)
    vocab = ["<s>", "</s>"] + list(word_names)
    uni = {w: float(-1.0 - 2.0 * rng.random()) for w in vocab}
    # the reference's ARPA reader (ngram_read_arpa.c:422-479) requires
    # 2-grams grouped by context and targets ascending in 1-gram order
    bi = {}
    for v in vocab:
        if v == "</s>":
            continue
        tgts = rng.choice(len(vocab), size=min(n_bi_per_word, len(vocab)),
                          replace=False)
        for t in sorted(int(t) for t in tgts):
            w = vocab[t]
            if w == "<s>":
                continue
            bi[(v, w)] = float(-0.3 - 1.5 * rng.random())
    out = io.StringIO()
    out.write("\n\\data\\\n")
    out.write(f"ngram 1={len(vocab)}\n")
    out.write(f"ngram 2={len(bi)}\n")
    out.write("\n\\1-grams:\n")
    for w, p in uni.items():
        out.write(f"{p:.4f}\t{w}\t-0.3000\n")
    out.write("\n\\2-grams:\n")
    for (v, w), p in bi.items():
        out.write(f"{p:.4f}\t{v} {w}\n")
    out.write("\n\\end\\\n")
    return out.getvalue()


def sample_frames(hmm, phone_ids, rng, max_frames=3000):
    """Sample observation frames from the generative model (HMMSet)."""
    frames = []
    for pid in phone_ids:
        ns = int(hmm.phone_ns[pid])
        trans = hmm.phone_trans[pid]
        s = 0
        while s < ns:
            senone = int(hmm.phone_states[pid, s])
            mixes = hmm.state_mix[senone]
            lws = hmm.state_lw[senone]
            valid = mixes >= 0
            w = np.exp(lws[valid])
            w /= w.sum()
            k = rng.choice(np.flatnonzero(valid), p=w)
            g = int(mixes[k])
            var = 1.0 / hmm.ivars[g]
            frames.append(hmm.means[g]
                          + np.sqrt(var) * rng.standard_normal(len(var)))
            s += 0 if rng.random() <= math.exp(trans[s + 1, s + 1]) else 1
            if len(frames) >= max_frames:
                return np.asarray(frames, np.float32)
    return np.asarray(frames, np.float32)


# ---------------------------------------------------------------------------
# Reference runner
# ---------------------------------------------------------------------------


def run_reference(binary, args, cwd, timeout=3600):
    t0 = time.perf_counter()
    proc = subprocess.run([binary] + args, cwd=cwd, timeout=timeout,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    wall = time.perf_counter() - t0
    return proc.stdout, wall, proc.returncode


def parse_ref_output(text):
    """Per input file: the pass-2 best (fall back to pass-1 best).

    Output format from julius/output_stdout.c: `sentence1: ...` after each
    `input MFCC file:` banner; `pass1_best:` when pass 2 yields nothing."""
    results = []
    cur, cur1 = None, None
    for line in text.splitlines():
        if re.match(r"^input MFCC file:", line):
            if cur is not None or cur1 is not None:
                results.append(cur if cur is not None else cur1)
            cur, cur1 = None, None
        m = re.match(r"^pass1_best:\s*(.*)$", line)
        if m:
            cur1 = m.group(1).split()
        m = re.match(r"^sentence1:\s*(.*)$", line)
        if m:
            cur = m.group(1).split()
    if cur is not None or cur1 is not None:
        results.append(cur if cur is not None else cur1)
    return results


def wer(ref, hyp):
    """Levenshtein word error count and length."""
    n, m = len(ref), len(hyp)
    d = np.zeros((n + 1, m + 1), np.int32)
    d[:, 0] = np.arange(n + 1)
    d[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            d[i, j] = min(d[i - 1, j] + 1, d[i, j - 1] + 1,
                          d[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1]))
    return int(d[n, m]), n


# ---------------------------------------------------------------------------
# Scenario: small GMM — transcript parity
# ---------------------------------------------------------------------------


def scenario_small(ref_bin, workdir, n_utts, lm_weight=8.0, lm_penalty=-2.0,
                   seed=0, device="cuda"):
    from julius_tpu_torch.config import SearchConfig
    from julius_tpu_torch.engine import Engine
    from julius_tpu_torch.io.arpa import parse_arpa
    from julius_tpu_torch.io.htk_dict import Vocabulary, parse_dict_line
    from julius_tpu_torch.io.htk_hmm import parse_hmmdefs_text

    os.makedirs(workdir, exist_ok=True)
    phones = [f"ph{i}" for i in range(10)] + ["sil"]
    hmmdefs = gen_hmmdefs(phones, dim=8, n_states=3, n_mix=2, seed=seed,
                          kind="USER")
    dict_text, words = gen_dict(phones, n_words=40, seed=seed + 1)
    arpa = gen_arpa([w for w, _ in words], seed=seed + 2)
    paths = {}
    for name, content in [("hmmdefs", hmmdefs), ("words.dict", dict_text),
                          ("lm.arpa", arpa)]:
        paths[name] = os.path.join(workdir, name)
        with open(paths[name], "w") as f:
            f.write(content)

    hmm = parse_hmmdefs_text(hmmdefs)
    voca = Vocabulary()
    for line in dict_text.splitlines():
        parse_dict_line(line, voca)
    lm = parse_arpa(io.StringIO(arpa))
    name2id = {n: i for i, n in enumerate(voca.names)}

    # generate utterances: truth = <s> w... </s>
    rng = np.random.default_rng(seed + 3)
    truths, mfc_files, all_frames = [], [], []
    for u in range(n_utts):
        k = int(rng.integers(2, 5))
        seq = (["<s>"]
               + [words[int(j)][0]
                  for j in rng.integers(0, len(words), size=k)]
               + ["</s>"])
        phone_ids = []
        for wname in seq:
            for p in voca.phones[name2id[wname]]:
                phone_ids.append(hmm.phone_index[p])
        frames = sample_frames(hmm, phone_ids, rng)
        mfc = os.path.join(workdir, f"utt{u:03d}.mfc")
        write_htk_param(mfc, HTKParam(data=frames, samp_period=100000,
                                      kind="USER"))
        truths.append(seq)
        mfc_files.append(mfc)
        all_frames.append(frames)
    listfile = os.path.join(workdir, "list.txt")
    with open(listfile, "w") as f:
        f.write("\n".join(mfc_files) + "\n")

    # --- reference decode
    ref_args = ["-h", paths["hmmdefs"], "-v", paths["words.dict"],
                "-nlr", paths["lm.arpa"],
                "-input", "mfcfile", "-filelist", listfile,
                "-lmp", str(lm_weight), str(lm_penalty),
                "-lmp2", str(lm_weight), str(lm_penalty),
                "-b", "0", "-n", "1", "-output", "1"]
    ref_out, ref_wall, rc = run_reference(ref_bin, ref_args, workdir)
    ref_results = parse_ref_output(ref_out)
    if rc != 0 or len(ref_results) != n_utts:
        tail = "\n".join(ref_out.splitlines()[-40:])
        raise RuntimeError(
            f"reference run failed rc={rc} results={len(ref_results)}"
            f"/{n_utts}\n{tail}")

    # --- our decode (batched)
    eng = Engine(hmm, voca, lm,
                 search=SearchConfig(lm_weight=lm_weight,
                                     lm_penalty=lm_penalty,
                                     lm_weight2=lm_weight,
                                     lm_penalty2=lm_penalty,
                                     trellis_topm=64), device=device)
    T = max(f.shape[0] for f in all_frames)
    batch = np.zeros((n_utts, T, all_frames[0].shape[1]), np.float32)
    lens = np.zeros(n_utts, np.int32)
    for i, f in enumerate(all_frames):
        batch[i, :f.shape[0]] = f
        lens[i] = f.shape[0]
    t0 = time.perf_counter()
    ours = eng.decode_features(batch, lens)
    our_wall = time.perf_counter() - t0

    # --- compare (reference prints output symbols; <s>/</s> have empty
    # output "[]" so they vanish from its transcripts — match that)
    agree = 0
    ref_err = ref_len = our_err = 0
    mism = []
    for i in range(n_utts):
        r = ref_results[i] or []
        o = [t for t in ours[i].texts if t] if ours[i].valid else []
        truth = [w for w in truths[i] if w not in ("<s>", "</s>")]
        if r == o:
            agree += 1
        else:
            mism.append({"utt": i, "truth": " ".join(truth),
                         "ref": " ".join(r), "ours": " ".join(o)})
        e, n = wer(truth, r)
        ref_err += e
        ref_len += n
        e, _ = wer(truth, o)
        our_err += e
    return {
        "scenario": "small_gmm_parity",
        "n_utts": n_utts,
        "transcript_agreement": agree / n_utts,
        "ref_wer": ref_err / ref_len,
        "our_wer": our_err / ref_len,
        "ref_wall_s": round(ref_wall, 3),
        "our_wall_s": round(our_wall, 3),
        "mismatches": mism,
    }


# ---------------------------------------------------------------------------
# Scenario: flagship DNN — speed baseline
# ---------------------------------------------------------------------------


def export_flagship(workdir, n_phones, n_words, hidden, n_layers, dim,
                    context, seed=0):
    """Write flagship-scale models in the reference's formats and return
    the julius_tpu_torch-side objects built from the same numbers."""
    from julius_tpu_torch.io.dnn import DNNParams
    from julius_tpu_torch.tools.synth import (make_hmmset, make_ngram,
                                              make_vocabulary)

    os.makedirs(workdir, exist_ok=True)
    hmm = make_hmmset(n_phones=n_phones, dim=dim, seed=seed)
    voca = make_vocabulary(hmm, n_words=n_words, seed=seed + 1)
    lm = make_ngram(voca, seed=seed + 2)
    n_out = hmm.n_states

    # hmmdefs ascii with explicit <SID> so the reference's DNN output
    # indexing matches ours (dnntools/embed_sid.pl convention)
    with open(os.path.join(workdir, "hmmdefs"), "w") as f:
        f.write(f"~o <VecSize> {dim} <USER> <DIAGC> <NULLD>\n")
        for pi, name in enumerate(hmm.phone_names):
            ns = int(hmm.phone_ns[pi])
            f.write(f'~h "{name}"\n<BeginHMM>\n<NumStates> {ns + 2}\n')
            for s in range(ns):
                sen = int(hmm.phone_states[pi, s])
                f.write(f"<State> {s + 2}\n<SID> {sen}\n")
                g = int(hmm.state_mix[sen, 0])
                mean = hmm.means[g]
                var = 1.0 / hmm.ivars[g]
                f.write(f"<Mean> {dim}\n ")
                f.write(" ".join(f"{x:.4f}" for x in mean) + "\n")
                f.write(f"<Variance> {dim}\n ")
                f.write(" ".join(f"{x:.4f}" for x in var) + "\n")
            N = ns + 2
            f.write(f"<TransP> {N}\n")
            tp = np.exp(hmm.phone_trans[pi][:N, :N])
            tp[tp < 1e-8] = 0.0
            for r in range(N):
                f.write(" " + " ".join(f"{x:.6f}" for x in tp[r]) + "\n")
            f.write("<EndHMM>\n")

    with open(os.path.join(workdir, "words.dict"), "w") as f:
        for i, name in enumerate(voca.names):
            phones = " ".join(voca.phones[i])
            if name in ("<s>", "</s>"):
                f.write(f"{name}\t[]\t{phones}\n")
            else:
                f.write(f"{name}\t[{name}]\t{phones}\n")

    with open(os.path.join(workdir, "lm.arpa"), "w") as f:
        uni, bi = lm.ngrams[0], lm.ngrams[1]
        f.write(f"\n\\data\\\nngram 1={len(uni)}\nngram 2={len(bi)}\n")
        f.write("\n\\1-grams:\n")
        for (w,), (p, bo) in uni.items():
            f.write(f"{p:.4f}\t{lm.words[w]}\t{bo:.4f}\n")
        f.write("\n\\2-grams:\n")
        # grouped by context, targets ascending (ngram_read_arpa.c:422-479)
        for (v, w) in sorted(bi.keys()):
            f.write(f"{bi[(v, w)][0]:.4f}\t{lm.words[v]} {lm.words[w]}\n")
        f.write("\n\\end\\\n")

    # DNN weights: reference wants row-major [out, in] raw order
    # (calc_dnn.c:409 load_npy(l->w, wfile, l->in, l->out) read linearly,
    # consumed as dst[o] = sum_i w[o*in+i]*src[i]).  NB the reference's
    # FMA kernel (calc_dnn_fma.c:25 n = in/8, unchecked for FMA in
    # dnn_layer_load) requires every layer's input size % 8 == 0 —
    # dim*context and hidden must satisfy that.
    from julius_tpu_torch.tools.synth import trained_dnn_weights
    din = dim * context
    weights, biases, out_w, out_b, protos = trained_dnn_weights(
        n_out, din, dim, context, hidden, n_layers, seed)
    conf = [f"feature_type USER\nfeature_len {dim}\ncontext_len {context}",
            f"input_nodes {din}\noutput_nodes {n_out}",
            f"hidden_nodes {hidden}\nhidden_layers {n_layers}"]
    for i, (w, b) in enumerate(zip(weights, biases)):
        np.save(os.path.join(workdir, f"W{i+1}.npy"),
                np.ascontiguousarray(w.T))
        np.save(os.path.join(workdir, f"B{i+1}.npy"), b.reshape(-1, 1))
        conf.append(f"W{i+1} W{i+1}.npy\nB{i+1} B{i+1}.npy")
    np.save(os.path.join(workdir, "W_out.npy"), np.ascontiguousarray(out_w.T))
    np.save(os.path.join(workdir, "B_out.npy"), out_b.reshape(-1, 1))
    with open(os.path.join(workdir, "prior.dnn"), "w") as f:
        for i in range(n_out):
            f.write(f"{i} {1.0 / n_out:e}\n")
    conf += ["output_W W_out.npy", "output_B B_out.npy",
             "state_prior prior.dnn", "state_prior_factor 1.0",
             "batch_size 64", f"num_threads {os.cpu_count() or 4}"]
    with open(os.path.join(workdir, "dnn.conf"), "w") as f:
        f.write("\n".join(conf) + "\n")

    dnn = DNNParams(weights=weights, biases=biases, output_w=out_w,
                    output_b=out_b,
                    log_prior=np.full(n_out, math.log10(1.0 / n_out),
                                      np.float32),
                    context_len=context, feature_len=dim)
    return hmm, voca, lm, dnn, protos


from julius_tpu_torch.tools.synth import make_flagship_utts  # noqa: E402,F401


def scenario_flagship(ref_bin, workdir, n_utts,
                      n_phones=668, n_words=5000, hidden=2048, n_layers=5,
                      dim=120, context=11, seed=0, lm_weight=8.0,
                      lm_penalty=-2.0, device="cuda"):
    """Flagship DNN-HMM parity: WER + speed.  Reference julius (AVX/FMA
    + OpenMP DNN) vs julius_tpu_torch on identical feature files at
    flagship-scale models, generative utterances (truth known)."""
    from julius_tpu_torch.config import SearchConfig
    from julius_tpu_torch.engine import Engine
    from julius_tpu_torch.utils.device import resolve_device

    hmm, voca, lm, dnn, protos = export_flagship(
        workdir, n_phones, n_words, hidden, n_layers, dim, context, seed)
    truths, windows, lens_list = make_flagship_utts(
        hmm, voca, lm, protos, n_utts, dim, context, seed=seed)

    # in the buffered mfcfile+DNN path the reference does NOT splice:
    # dnn_calc_outprob (calc_dnn.c:800) memcpys inputnodenum floats
    # straight from the param row, so rows must already be
    # dim*context wide (splicing lives only in the realtime path,
    # realtime-1stpass.c:447 splice_mfcc); we feed both decoders the
    # identical spliced rows
    mfc_files = []
    for u, win in enumerate(windows):
        mfc = os.path.join(workdir, f"utt{u:03d}.mfc")
        write_htk_param(mfc, HTKParam(data=win, samp_period=100000,
                                      kind="USER"))
        mfc_files.append(mfc)
    listfile = os.path.join(workdir, "list.txt")
    with open(listfile, "w") as f:
        f.write("\n".join(mfc_files) + "\n")

    lmp = [str(lm_weight), str(lm_penalty)]
    # -b 0 = full beam: the auto-guessed width (m_chkparam.c
    # set_beam_width) collapses on this synthetic AM's unnormalised
    # scores, and our decoder is dense/full-beam — apples to apples
    ref_args = ["-h", "hmmdefs", "-v", "words.dict", "-nlr", "lm.arpa",
                "-dnnconf", "dnn.conf", "-b", "0",
                "-input", "mfcfile", "-filelist", "list.txt",
                "-lmp", *lmp, "-lmp2", *lmp,
                "-n", "1", "-output", "1"]
    ref_out, ref_wall, rc = run_reference(ref_bin, ref_args, workdir)
    ref_results = parse_ref_output(ref_out)
    if rc != 0:
        tail = "\n".join(ref_out.splitlines()[-40:])
        raise RuntimeError(f"reference flagship run failed rc={rc}\n{tail}")

    eng = Engine(hmm, voca, lm, dnn=dnn,
                 search=SearchConfig(lm_weight=lm_weight,
                                     lm_penalty=lm_penalty,
                                     lm_weight2=lm_weight,
                                     lm_penalty2=lm_penalty), device=device)
    T = max(lens_list)
    batch = np.zeros((n_utts, T, dim * context), np.float32)
    for u, win in enumerate(windows):
        batch[u, :win.shape[0]] = win
    lens = np.asarray(lens_list, dtype=np.int32)
    dev = resolve_device(device)

    def decode():
        t0 = time.perf_counter()
        res = eng.decode_features(batch, lens)
        if dev.type == "cuda":
            import torch
            torch.cuda.synchronize(dev)
        return res, time.perf_counter() - t0

    # the first decode builds the kernels and warms the caches
    res, compile_wall = decode()
    res, our_wall = decode()

    # accuracy: truth is known by construction; the reference prints
    # output symbols, <s>/</s> have empty "[]" output
    agree = ref_err = our_err = ref_len = 0
    mism = []
    for u in range(n_utts):
        truth = [w for w in truths[u] if w not in ("<s>", "</s>")]
        r = ref_results[u] if u < len(ref_results) and ref_results[u] \
            else []
        o = [t_ for t_ in res[u].texts if t_] if res[u].valid else []
        if r == o:
            agree += 1
        elif len(mism) < 10:
            mism.append({"utt": u, "truth": " ".join(truth),
                         "ref": " ".join(r), "ours": " ".join(o)})
        e, n = wer(truth, r)
        ref_err += e
        ref_len += n
        e, _ = wer(truth, o)
        our_err += e

    audio_total = sum(lens_list) / 100.0
    return {
        "scenario": "flagship_dnn_parity",
        "n_utts": n_utts,
        "audio_seconds": round(audio_total, 1),
        "ref_wall_s": round(ref_wall, 2),
        "ref_xrt": round(audio_total / ref_wall, 2),
        "our_wall_s": round(our_wall, 2),
        "our_xrt": round(audio_total / our_wall, 2),
        "our_compile_s": round(compile_wall, 1),
        "speedup": round(ref_wall / our_wall, 2),
        "transcript_agreement": round(agree / n_utts, 4),
        "ref_wer": round(ref_err / max(1, ref_len), 4),
        "our_wer": round(our_err / max(1, ref_len), 4),
        "mismatches": mism,
    }


# ---------------------------------------------------------------------------
# Scenario: tied-triphone LVCSR — HMMList + pseudo CD sets both sides
# ---------------------------------------------------------------------------


def export_triphone(workdir, n_base, variants, n_words, dim, tied_pool,
                    seed=0):
    """Write a tied-state triphone GMM config in the reference's own
    formats — ascii hmmdefs with every physical model
    (rdhmmdef.c:262), an HMMList mapping each word-internal logical
    triphone to its physical (rdhmmlist.c:70; identity lines for the
    directly-defined names), HTK dict over BASE phones (the reference
    composes the triphones itself under -ccd the same way
    network.word_phone_names does), and ARPA — and return the
    julius_tpu_torch-side objects built from the same numbers."""
    from julius_tpu_torch.tools.synth import (bind_triphones, make_ngram,
                                              make_triphone_hmmset,
                                              make_vocabulary)

    os.makedirs(workdir, exist_ok=True)
    hmm = make_triphone_hmmset(n_base=n_base, variants=variants, dim=dim,
                               tied_pool=tied_pool, seed=seed)
    voca = make_vocabulary(hmm, n_words=n_words, seed=seed + 1)
    bind_triphones(hmm, voca, n_base=n_base, variants=variants)
    lm = make_ngram(voca, seed=seed + 2)

    with open(os.path.join(workdir, "hmmdefs"), "w") as f:
        f.write(f"~o <VecSize> {dim} <USER> <DIAGC> <NULLD>\n")
        for pi, name in enumerate(hmm.phone_names):
            ns = int(hmm.phone_ns[pi])
            f.write(f'~h "{name}"\n<BeginHMM>\n<NumStates> {ns + 2}\n')
            for s in range(ns):
                sen = int(hmm.phone_states[pi, s])
                g = int(hmm.state_mix[sen, 0])
                mean = hmm.means[g]
                var = 1.0 / hmm.ivars[g]
                f.write(f"<State> {s + 2}\n<Mean> {dim}\n ")
                f.write(" ".join(f"{x:.5f}" for x in mean) + "\n")
                f.write(f"<Variance> {dim}\n ")
                f.write(" ".join(f"{x:.5f}" for x in var) + "\n")
            N = ns + 2
            f.write(f"<TransP> {N}\n")
            tp = np.exp(hmm.phone_trans[pi][:N, :N])
            tp[tp < 1e-8] = 0.0
            for r in range(N):
                f.write(" " + " ".join(f"{x:.6f}" for x in tp[r]) + "\n")
            f.write("<EndHMM>\n")

    with open(os.path.join(workdir, "hmmlist"), "w") as f:
        for name in hmm.phone_names:
            f.write(f"{name}\n")
        for lname, pidx in sorted(hmm.logical_map.items()):
            f.write(f"{lname} {hmm.phone_names[pidx]}\n")

    with open(os.path.join(workdir, "words.dict"), "w") as f:
        for i, name in enumerate(voca.names):
            phones = " ".join(voca.phones[i])
            out_sym = voca.outputs[i]
            f.write(f"{name}\t[{out_sym}]\t{phones}\n")

    with open(os.path.join(workdir, "lm.arpa"), "w") as f:
        uni, bi = lm.ngrams[0], lm.ngrams[1]
        f.write(f"\n\\data\\\nngram 1={len(uni)}\nngram 2={len(bi)}\n")
        f.write("\n\\1-grams:\n")
        for (w,), (p, bo) in uni.items():
            f.write(f"{p:.4f}\t{lm.words[w]}\t{bo:.4f}\n")
        f.write("\n\\2-grams:\n")
        for (v, w) in sorted(bi.keys()):
            f.write(f"{bi[(v, w)][0]:.4f}\t{lm.words[v]} {lm.words[w]}\n")
        f.write("\n\\end\\\n")
    return hmm, voca, lm


def _triphone_utt_frames(hmm, voca, wid_seq, rng):
    """Frames sampled from the logical-triphone senone path of a word
    sequence (word-internal logicals via the HMMList map; word-edge
    partial names from the base monophone, whose states are members of
    the pseudo CD sets both decoders score them with)."""
    from julius_tpu_torch.models.hmm import center_name
    from julius_tpu_torch.search.network import word_phone_names

    senones = []
    for w in wid_seq:
        for name in word_phone_names(voca.phones[w], True):
            pid = hmm.logical_map.get(name)
            if pid is None:
                pid = hmm.phone_index.get(name)
            if pid is None:
                pid = hmm.phone_index[center_name(name)]
            ns = int(hmm.phone_ns[pid])
            trans = hmm.phone_trans[pid]
            s = 0
            while s < ns:
                senones.append(int(hmm.phone_states[pid, s]))
                if rng.random() > math.exp(trans[s + 1, s + 1]):
                    s += 1
    g = hmm.state_mix[np.asarray(senones), 0]
    var = 1.0 / hmm.ivars[g]
    return (hmm.means[g]
            + np.sqrt(var) * rng.standard_normal(var.shape)
            ).astype(np.float32)


def scenario_triphone(ref_bin, workdir, n_utts, n_base=20, variants=12,
                      n_words=1000, dim=16, tied_pool=600, seed=0,
                      lm_weight=8.0, lm_penalty=-2.0, device="cuda"):
    """Tied-triphone LVCSR parity (VERDICT r4 #3: the golden tests
    covered only a 4-phone toy): HMMList logical->physical tying and
    cross-word pseudo CD sets active in BOTH decoders, identical
    feature files, transcript agreement + WER vs the generative truth.
    Reference: rdhmmlist.c, cdset.c, README.md:24 (20k dictation)."""
    from julius_tpu_torch.config import SearchConfig
    from julius_tpu_torch.engine import Engine

    hmm, voca, lm = export_triphone(workdir, n_base, variants, n_words,
                                    dim, tied_pool, seed)
    name2id = {n: i for i, n in enumerate(voca.names)}
    rng = np.random.default_rng(seed + 3)
    from julius_tpu_torch.tools.synth import _lm_sampler
    draw = _lm_sampler(lm, voca, rng)
    truths, mfc_files, all_frames = [], [], []
    for u in range(n_utts):
        k = int(rng.integers(3, 6))
        seq = [name2id["<s>"]]
        for _ in range(k):
            seq.append(draw(seq[-1]))
        seq.append(name2id["</s>"])
        frames = _triphone_utt_frames(hmm, voca, seq, rng)
        mfc = os.path.join(workdir, f"utt{u:03d}.mfc")
        write_htk_param(mfc, HTKParam(data=frames, samp_period=100000,
                                      kind="USER"))
        truths.append([voca.outputs[w] for w in seq if voca.outputs[w]])
        mfc_files.append(mfc)
        all_frames.append(frames)
    listfile = os.path.join(workdir, "list.txt")
    with open(listfile, "w") as f:
        f.write("\n".join(mfc_files) + "\n")

    lmp = [str(lm_weight), str(lm_penalty)]
    ref_args = ["-h", "hmmdefs", "-hlist", "hmmlist", "-v", "words.dict",
                "-nlr", "lm.arpa", "-input", "mfcfile",
                "-filelist", "list.txt", "-lmp", *lmp, "-lmp2", *lmp,
                "-b", "0", "-n", "1", "-output", "1"]
    ref_out, ref_wall, rc = run_reference(ref_bin, ref_args, workdir)
    ref_results = parse_ref_output(ref_out)
    if rc != 0:
        tail = "\n".join(ref_out.splitlines()[-40:])
        raise RuntimeError(f"reference triphone run failed rc={rc}\n{tail}")

    eng = Engine(hmm, voca, lm,
                 search=SearchConfig(lm_weight=lm_weight,
                                     lm_penalty=lm_penalty,
                                     lm_weight2=lm_weight,
                                     lm_penalty2=lm_penalty), device=device)
    T = max(f.shape[0] for f in all_frames)
    batch = np.zeros((n_utts, T, dim), np.float32)
    lens = np.zeros(n_utts, np.int32)
    for i, f in enumerate(all_frames):
        batch[i, :f.shape[0]] = f
        lens[i] = f.shape[0]
    t0 = time.perf_counter()
    ours = eng.decode_features(batch, lens)
    our_wall = time.perf_counter() - t0

    agree = ref_err = our_err = ref_len = 0
    mism = []
    for i in range(n_utts):
        r = ref_results[i] or [] if i < len(ref_results) else []
        o = [t for t in ours[i].texts if t] if ours[i].valid else []
        truth = truths[i]
        if r == o:
            agree += 1
        elif len(mism) < 10:
            mism.append({"utt": i, "truth": " ".join(truth),
                         "ref": " ".join(r), "ours": " ".join(o)})
        e, n = wer(truth, r)
        ref_err += e
        ref_len += n
        e, _ = wer(truth, o)
        our_err += e
    audio_total = sum(int(l) for l in lens) / 100.0
    return {
        "scenario": "triphone_lvcsr_parity",
        "n_utts": n_utts,
        "n_words": n_words,
        "n_logical_triphones": len(hmm.logical_map),
        "audio_seconds": round(audio_total, 1),
        "transcript_agreement": round(agree / n_utts, 4),
        "ref_wer": round(ref_err / max(1, ref_len), 4),
        "our_wer": round(our_err / max(1, ref_len), 4),
        "ref_wall_s": round(ref_wall, 2),
        "our_wall_s": round(our_wall, 2),
        "mismatches": mism,
    }


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ref", required=True, help="reference julius binary")
    ap.add_argument("--workdir", default=None,
                    help="write the models and features here (default: "
                         "a new temporary directory)")
    ap.add_argument("--device", default=device,
                    help="the port's device (default: %(default)s)")
    ap.add_argument("--scale", choices=["small", "flagship", "triphone"],
                    default="small")
    ap.add_argument("--n-utts", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write the result JSON to this path")
    ap.add_argument("--update-baseline", default=None, metavar="PATH",
                    help="record the measured reference xRT/WER into "
                         "BASELINE.json['measured'] (read by bench.py)")
    args = ap.parse_args(argv)
    workdir = args.workdir or tempfile.mkdtemp(prefix="refparity_")
    scenario = {"small": scenario_small, "triphone": scenario_triphone,
                "flagship": scenario_flagship}[args.scale]
    r = scenario(args.ref, workdir, args.n_utts, seed=args.seed,
                 device=args.device)
    print(json.dumps(r, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(r, f, indent=1)
    if args.update_baseline:
        with open(args.update_baseline) as f:
            base = json.load(f)
        base["measured"] = {
            "ref_xrt": r.get("ref_xrt"),
            "ref_wer": r.get("ref_wer"),
            "our_wer": r.get("our_wer"),
            "scale": args.scale,
            "n_utts": args.n_utts,
        }
        with open(args.update_baseline, "w") as f:
            json.dump(base, f, indent=1)
    return r


if __name__ == "__main__":
    main()
