#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, in order (any failure exits non-zero):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds every kernel of the main path from this checkout,
     and word_end's phase-stamp build (-DWORD_END_PHASES), one nvcc
     process per library, all at once; ptxas must report no stack and
     no spills for any kernel;
  3. kernel: each kernel against its plain PyTorch version on the card at
     the main path's shapes (scores within atol 1e-5, integers equal),
     then timed with CUDA events (median of 60 launches after warm-up)
     beside the plain version and the bound: pass1_step (the pass-1 beam
     update) and scan_win (the pass-2 windowed word scan, at the device
     A*'s shape, two of the host re-scan's window buckets, and its edges:
     one frame, a chunk less and more one frame, the whole utterance, and
     chains of 45 nodes);
     word_end (pass 1's word-end stage) is checked on the decodes'
     own states instead: every path's word_end_check line holds each
     recorded shape's kept states bit-equal to word_end_plain, and its
     kernel_path line times it there ((a) and (c) as pass1_step's,
     torch.topk of the same exit scores beside it, the byte bound, the
     cluster plan (C, threads) each shape took; on the slice and lvcsr
     also each shape's phase split from the phase-stamp build); suffix
     (the device A*'s suffix DP) likewise on the decodes' own trellises:
     every path's suffix_check line holds each device A* call's estimate
     bit-equal to its plain version `suffix_plain` on every utterance and
     times the first call beside one plain pass (on the slice at B = 16
     and B = 1, on lvcsr, on each command-line and server path);
  4. slice: the full-width flagship engine (5000-word 2-gram, 2004
     senones, 5 x 2048 sigmoid DNN) with the reference's search
     configuration decodes 16 generative utterances through
     Engine.decode_features on the card (DNN, pass 1, device A*, retry
     net, N-best); the kernel launch counts are read around that run,
     then the same decode is staged, the kernel-path trellis is held
     against the plain-path trellis, and the device A* is run again with
     the plain scan in place of the kernel and held against the first;
     the host cost of the kernels' device guard (launch_guard), and one
     graphed pass 1 of the batch under torch.profiler (frame_profile:
     the kernels a frame and their time, the card's busy share; also
     for lvcsr);
  5. rescan: the host-driven re-scan (pass2_device=False) on 4 of the
     utterances, held to the device A*'s word ids;
  6. frozen: the frozen-score pass 2 (pass2_rescan=False) on 4 of them;
  7. grammar, the slice's path: a DFA grammar over the flagship's 5000
     words and model (tools.synth.make_grammar: 40 word categories and
     the <s> / </s> silence categories, routes of 1-8 categories and one
     tail-recursive rule) compiled by the port's grammar.compile_grammar;
     16 sentences it accepts (grammar_sentences, 3-10 words) decode
     through Engine.decode_features with the default pass 2, the host
     re-scan under the DFA, whose word scans launch scan_win; pass 1
     takes its unfused step, so pass1_step is launched no time.  scan_win
     is held and timed at the shapes the run gave it.  Then 4 of them
     decode with the frozen DFA search (pass2_rescan=False);
  8. isolated: lmtype "word" over the flagship's 5000 words, 16
     one-word utterances, pass 1 only;
  9. unfused_ngram: the flagship with factoring 2 and with a score
     envelope (beam_width 400), each on 4 utterances with the default
     pass 2; pass 1 alone timed a frame beside the fused path's on the
     same outprobs;
 10. waveform: the flagship engine's waveform path (front end, splice,
     DNN, pass 1: Engine._decode_device) on 64 x 10 s of seeded noise at
     16 kHz, timed as bench.py times it, with the launch counts read
     around one call; its front end held against the CPU front end on
     the same waveforms; Engine.recognize_batch end to end on two short
     waveforms;
 11. lvcsr: the 20k-word tied-triphone configuration at full width
     (lvcsr_engine: 299,718 nodes, 2040 senones plus the pseudo
     set-states' columns, 5 x 2048 DNN, strict inter-word CD in pass 2).
     Both kernels are held against their plain versions and timed at
     its shapes (pass1_step at B = 32 over the widened outprob row,
     scan_win at the A*'s shape with the word-head columns substituted
     by left-context class), the pseudo aggregation on the card against
     the CPU, and the pseudo kernel (csrc/pseudo.cu) at envr20k's shape
     (the benchmark configuration's own member table, 16 x 1107 rows)
     held bit-equal to the plain version and to the ATen path it
     replaced, then timed beside its byte bound, that ATen path and one
     host pass of the plain version (a kernel_time line); one pseudo
     launch a decode; then 32 generative utterances decode three times through
     Engine.decode_features (the first two calibrate the device A*'s
     spot-check), the launch counts are read around the third, and a
     staged decode splits its wall into DNN, pseudo aggregation, pass 1,
     device A*, retry net and assembly; then 8 of them decode with
     head_rc_dynamic (per-context head emission rows: pass 1's unfused
     step), timed as in 9;
 12. cli: the julius command line from model files.  A GMM-HMM task of
     the flagship's width (668 monophones x 3 states x 16 diagonal
     Gaussians at MFCC_E_D_A's 39 dims, the 5000-word 2-gram) is written
     with the port's writers (binhmm, HTK dictionary, bingram, 16
     generative utterances as HTK parameter files), and beside it a
     grammar over the same words (gram.dfa / gram.dict, mkdfa), a word
     list and 4 utterances of each; on the engine
     fusion.create_engines loads from them, the GMM scorer on the card
     against the CPU, the scorer's two stages (gauss_scores, the mixture
     log-sum-exp) timed against their bounds, and a staged decode that
     splits the wall; then recognize.main runs on all 16 files (-input
     mfcfile -batchsize 16), on 4 with -lattice -confnet -mbr -n 3 (the
     host re-scan), on 2 with -gshmm, on the 4 grammar files with -gram
     and on the 4 word files with -w, the launch counts read around
     each run.  Each run records the shapes the kernels get (and keeps
     the arguments of a few calls); after it, each kernel it launched is
     held against its plain version at every such shape, on the run's
     own arguments and on integer-valued inputs over the run's engine
     tables, and timed there: the run's entries carry the
     launch-weighted mean time, plain time and bound;
 13. gather: a topology with backward in-word arcs (pass 1's
     incoming-arc gather): no model in the repo has it at full width, so
     it is held card against CPU at the tests' size;
 14. align: -walign -palign -salign on 16 generative flagship
     utterances through Engine.decode_features (the slice's decode, then
     a forced alignment of each result: search/align.py's Viterbi on the
     card); every result aligned, the word segments tiling each
     utterance in transcript order, word boundaries within 3 frames of
     the generating ones; the alignment Viterbi held card against CPU on
     the same outprob rows (backpointers equal, score within 1e-3); the
     alignment's wall per utterance, split into build_chain (host), the
     outprob, the Viterbi, the read back and the backtrace (host);
 15. stream: 4 seeded 10 s waveforms, each fed to StreamSession (no VAD,
     16-frame blocks) in 100 ms chunks on the card and decoded by
     recognize_batch on the card: words equal, scores within 0.5; where
     the stream's outprob rows differ from the batch's; the ms of each
     16-frame block (outprob plus the pass-1 chunk, the unfused step at
     B = 1, replayed from its graph once a frame) beside the 160 ms of
     audio it carries, and the segment-end delay (finalize, pass 2,
     assembly); scan_win held and timed at the shapes the streams gave
     it;
 16. stream_vad: 3 noise bursts of 2 s between 1 s of near-silence fed
     with the VAD on: 3 segments, each equal to recognize_batch on the
     segment's samples; the native segmenter (built here from
     julius_tpu_torch/adin/native/adin.cpp) against the Python one on
     the same samples; on the cli task's GMM engine loaded with -gmm
     -gmmnoise -powerthres, the GMM-VAD gate over a feature stream (2
     segments) and power rejection;
 17. cli_live: on the cli task, recognize.main with -input fake:<wav>
     (capture, VAD, the streaming decode: 3 `live segment` blocks), -48
     on a 48 kHz file, -gmm verification of a speech file and a noise
     file (one rejected), -walign -palign -salign; each run's kernels
     held and timed at its shapes, as in 12;
 18. server: tools.serve.serve on the flagship engine on threads (the
     module protocol and adinnet on ports the system chooses); a module
     client's STATUS, VERSION, LISTPROCESS, PAUSE and RESUME held to the
     reference's replies; the stream phase's 4 waveforms sent over
     adinnet, one segment each, each <RECOGOUT> equal to that phase's
     recognize_batch (or <RECOGFAIL/> where that result is invalid), the
     delay from each segment end to its result; then tools.adintool
     sends the three-burst waveform (-in file -out adinnet): one result
     for each segment it sends, equal to recognize_batch on that
     segment's samples; scan_win held and timed at the shapes each part
     gave it;
 19. vecnet: the 16 utterances of phase 4 sent as feature vectors over
     vecnet (VecnetClient to a VecnetServer on a thread), one segment
     each, and decoded as one batch by decode_features (at least 15/16
     exact, the words of the first decode), then their senone rows in
     the outprob mode through decode_outprob (the same words); both
     kernels held and timed at each decode's shapes;
 20. server_grammar: the cli task's grammar served by a ModuleServer:
     GRAMINFO, CHANGEGRAM, ADDGRAM, DEACTIVATEGRAM, ACTIVATEGRAM,
     SYNCGRAM, ADDWORD, DELGRAM, each reply the reference's message and
     each rebuild of the full-width network on the card timed; the
     switched engine decodes the 4 grammar files exactly, accepted by its
     automaton;
 21. tools: tools.profile's stages on the flagship at B = 32 x 10 s, and
     again under its trace option, with the share of the traced window
     in which the card runs a kernel; recognize.main with -check
     triphone and -plugindir (the plugin receives the printed sentence1
     strings); wer.synthetic_eval(n_utts=8) on the card equal to the
     CPU's;
 22. backward: the flagship with its 2-gram's bigrams flipped into a
     backward (RL) model for pass 2 and the 2-gram as the forward model
     for pass 1 decodes the 16 utterances of phase 4 (pass1_step a
     frame, the frozen backward search on the host, no scan): all from
     pass 2, and 4 of them equal to the port's CPU decode of the card's
     outprob rows; recognize.main with -nlr + -nrl ARPA files on 4 cli
     files; register_user_lm with the 2-gram as a Python function on 4
     utterances (the host re-scan: scan_win launches equal its chunks);
 23. full_scan: ChainCache rows of 256 flagship words (bit-equal to the
     device tables'), scan_words over the 16 x 509 outprob batch and one
     scan_words_store round (with sentence starts, dropped rows and
     out-of-range anchors), each one scan_win launch at W = T, held
     exactly against the plain version and timed at W = T;
 24. parallel: on meshes that repeat the card, sharded_pass1 at S = 1,
     2, 4 on one flagship utterance (the shards equal to one shard, the
     words to the truth and to the single-device pass 1's); each S as a
     sharded_graph line: the frames replayed from the captured step (one
     graph a one-card row, one replay a frame) bit-equal to the eager
     oracle in all six trellis fields, ms a frame graphed and eager, one
     capture on the key's first call and none on the second; once more
     at S = 2 with the utterance padded past n_frames by 32 frames of
     the next one (its first n_frames rows equal to the unpadded
     trellis, sharing its graph);
     parallel_decode_fn with dp = 2 on 16 x 3 s against the engine's
     own unfused pass 1, and the DNN split over tp = 2 by shard_engine
     against the unsplit one;
 25. refexport: the reference-binary tools' exports at full width
     (refbaseline.export_model, refparity.export_flagship) read back by
     the port's readers, then 4 generative utterances as spliced
     feature files decoded by recognize.main on the exported files;
 26. a summary of the pass1_graph lines, one of the astar_graph lines,
     one of the stream_graph lines, one of the align_graph lines, one of
     the sharded_graph lines, the kernels' JSON line (one entry per
     kernel and path: pass1_step, scan_win and word_end), the card
     line, and the result line last.

Pass 1 runs on the card as replays of its captured frame step (a CUDA
graph, search/pass1.py), and every path that calls pass1_batch holds it
against its eager oracle (the same step once a frame from Python) on
the same batch: slice, waveform, lvcsr, isolated and gather directly,
every other path on each pass1_batch call of its recorded run.  Each
such check prints a pass1_graph line: the trellises bit-equal, the
kernel launches equal (counted on the graph's replays), the wall and ms
a frame of each, and the network's graphs and capture seconds so far.
The kernel's recorded calls (path_kernels) come from the oracle, since
a graph calls the wrapper only at capture; so do the word-end kernel's
(one launch a frame on every pass-1 path, fused or not; a stream's also
from its chunk oracles, its segment-end flushes and each chunk-graph
capture's eager first row), which every path holds bit-equal to the
plain version on those states (word_end_check lines: slice, lvcsr,
waveform and every path that records calls).

The device A* runs on the card as replays of its captured round (a CUDA
graph, search/pass2_device.py), the host reading its stop flag once
every STOP_EVERY replays; every path that calls run_batch (slice,
lvcsr, the unfused N-gram paths, cli, align, stream, cli_live, server,
vecnet) holds each call against its eager oracle (the same round once
a round from Python, eager=True) on the same inputs, and prints one
astar_graph line a path: N-best lists, rounds and pops equal, both
loop walls, the rounds the card ran (gated rounds past the end
included), host waits, captures and their seconds, and the A* wall's
prepare and readback.  scan_win's recorded calls on those paths come
from the oracle too, with the graph's rounds past the end added.  On
the slice and lvcsr inputs the A* also runs at each STOP_EVERY of
SWEEP_G (astar_stop_every lines), and one graphed run of its rounds
is profiled (astar_round_profile: kernels and kernel time a round); on
the slice's, capturing the round through torch.cuda.graph and directly
is timed in turns (capture_cost).

A stream's pass-1 chunk runs on the card as replays of its captured
chunk row (a CUDA graph a network, search/pass1.py), and the alignment
Viterbi as replays of its captured frame (a graph a bucket of chain
sizes, search/align.py).  Every path that streams (stream, stream_vad,
cli_fake, server, server_adintool) or aligns (align, cli_align) keeps
each call of its run (kept_loops) and runs it again after the run,
graphed and as its eager oracle (eager=True: the same body once a row
or frame from Python) on the same inputs: a stream_graph line a path
(every chunk's atoms and state bit-equal, one graph launch a chunk
row, ms a block and a frame of both, captures) and an align_graph line
a path (score, backpointers and best node bit-equal, one launch a
frame, no more captures than buckets, ms an utterance and a frame of
both, and the alignment's wall split).

Weights and utterances are made from fixed seeds; nothing is read from
outside the repository.  Exits non-zero without a result where CUDA is
not available.
"""

import contextlib
import dataclasses
import inspect
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
F32_OPS_PER_S = 67e12         # H100 SXM float32 rate outside tensor cores
N_UTTS = 16
N_SIDE = 4                    # utterances for the rescan / frozen phases
N_LVCSR = 32                  # bench.py's lvcsr_20k batch
N_RC = 8                      # lvcsr utterances for head_rc_dynamic
N_CATS = 40                   # word categories of the grammar phase
N_WAVE, WAVE_S = 64, 10.0     # bench.py's waveform batch and length
STEP_BATCHES = (64, 32, N_UTTS, 4, 2, 1)   # pass1_step's kernel phase
DEVICE = "cuda"
LOG_ZERO = -1e10


def phase(label, **kv):
    print(json.dumps({"phase": label, **kv}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if out else ""


def step_inputs(dev, etot, B, R, seed, ties, padded=False):
    """One frame's beam-update arguments at the network's shapes.
    ties=True: integer-valued scores and arc/entry tables, so shifted
    candidates and entries tie exactly; else the network's own tables.
    padded=True: the node axis as pass1_batch gives it to the kernel
    (`search.pass1.kernel_tables`: padded to a multiple of 4)."""
    from julius_tpu_torch.search.pass1 import kernel_tables
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    sidx = dev.score_idx
    if padded:
        loc_k, etot, sidx = kernel_tables(dev)
        dev = types.SimpleNamespace(loc_lp=loc_k)
    N, K1 = dev.loc_lp.shape[1], dev.loc_lp.shape[0]

    def rnd(*shape):
        return torch.rand(shape, generator=g, device=DEVICE)

    def rint(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g, device=DEVICE)

    if ties:
        score = rint(-40, 0, B, N).float()
        loc = rint(-3, 1, K1, N).float()
        loc[rnd(K1, N) < 0.3] = LOG_ZERO
        et = rint(-6, 0, N).float()
        et[rnd(N) < 0.7] = LOG_ZERO
        ent = rint(-40, -20, B).float()
    else:
        score = -100.0 - 50.0 * rnd(B, N)
        loc, et = dev.loc_lp, etot
        ent = -100.0 - 20.0 * rnd(B)
    score[rnd(B, N) < 0.2] = LOG_ZERO
    score[:, 1000:5000] = LOG_ZERO
    ent[0] = LOG_ZERO
    fv = torch.ones(B, dtype=torch.bool, device=DEVICE)
    fv[1::7] = False
    return dict(
        score=score, ctx=rint(-1, 5000, B, N).int(),
        prev=rint(-1, 100000, B, N).int(), loc_lp=loc.contiguous(),
        entry_total=et.contiguous(), row=-10.0 * rnd(B, R),
        score_idx=sidx, ent_s=ent, ectx_s=rint(-1, 5000, B).int(),
        eprev_s=rint(-1, 100000, B).int(), frame_valid=fv)


def compare_step(pk, args):
    """Kernel vs plain on the same arguments, each writing a state set of
    its own (the kernel's filled with NaN and INT_MIN first, so a node it
    leaves unwritten shows; an `out` among the arguments is set aside)
    -> (max |score err|, outs)."""
    args = {k: v for k, v in args.items() if k != "out"}
    state = args["score"], args["ctx"], args["prev"]
    poison = tuple(torch.full_like(t, float("nan")) if t.is_floating_point()
                   else torch.full_like(t, torch.iinfo(t.dtype).min)
                   for t in state)
    got = pk.fused_step(**args, out=poison)
    want = pk.fused_step_plain(**args,
                               out=tuple(torch.empty_like(t) for t in state))
    torch.cuda.synchronize()
    err = float((got[0] - want[0]).abs().max())
    if not err <= 1e-5:
        raise RuntimeError(f"kernel scores differ from plain by {err}")
    for i, name in ((1, "ctx"), (2, "prev")):
        if not torch.equal(got[i], want[i]):
            n_bad = int((got[i] != want[i]).sum())
            raise RuntimeError(f"kernel {name} differs at {n_bad} nodes")
    return err, got


def step_bytes(B, N, K1, R):
    """Least bytes one frame must move: state read once and written once,
    the arc/entry/senone-map tables and the frame row read once."""
    state = B * N * (4 + 4 + 4)
    return 2 * state + K1 * N * 4 + N * 4 + N * 4 + B * R * 4 + B * 13


def step_ops(B, N, K1):
    """f32 operations one frame does: per node K+1 arc adds, K compares,
    an entry add and compare, an emission add and its compare."""
    return B * N * (2 * K1 + 3)


def scan_inputs(tabs, K, W, T, R, B, seed, ties, heads=None):
    """One windowed scan's arguments on the card.  Chains are vocabulary
    words (every fifth the dead chain, word id V) with the engine's own
    tables, or, with ties=True, integer-valued tables so shifted arcs,
    entries and word ends tie exactly; seeds hold LOG_ZERO runs and every
    fourth window ends at the last frame.  With `heads` (strict
    inter-word CD tables) each chain's word-head columns are those of a
    random left-context class, as the device A* substitutes them."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    V = tabs.n_words

    def rint(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g, device=DEVICE)

    def rnd(*shape):
        return torch.rand(shape, generator=g, device=DEVICE)

    wids = rint(0, V, K)
    wids[::5] = V
    loc, ent, ext = tabs.loc[wids], tabs.ent[wids], tabs.ext[wids]
    sidx = tabs.sidx[wids]
    if heads is not None:
        from julius_tpu_torch.search.scan import head_substituted_sidx
        lcc = rint(0, heads.head_sidx.shape[1], K)
        sidx = head_substituted_sidx(sidx, wids, lcc, heads.head_sidx,
                                     heads.head_ns)
    if ties:
        loc = rint(-2, 1, *loc.shape).float()
        loc[rnd(*loc.shape) < 0.2] = LOG_ZERO
        ent = rint(-3, 0, *ent.shape).float()
        ent[rnd(*ent.shape) < 0.7] = LOG_ZERO
        ext = rint(-1, 1, *ext.shape).float()
        ext[rnd(*ext.shape) < 0.3] = LOG_ZERO
        out = rint(-4, 3, B, T, R).float()
        seed_w = rint(-60, -20, K, W).float()
    else:
        out = -10.0 * rnd(B, T, R)
        seed_w = -200.0 - 100.0 * rnd(K, W)
    seed_w[rnd(K, W) < 0.6] = LOG_ZERO
    seed_w[:, 5:20] = LOG_ZERO
    t0 = rint(0, T - W + 1, K)
    t0[1::4] = T - W
    return dict(loc=loc.contiguous(), ent=ent.contiguous(),
                ext=ext.contiguous(), sidx=sidx.contiguous(),
                seed=seed_w.contiguous(), out_ext=out,
                bidx=rint(0, B, K).int(), t0=t0.int())


def synthetic_chains(V, N, kl, R, seed):
    """Chain tables of V words of N nodes with arc span kl and random
    log-probabilities (word id V the dead chain), for chain widths the
    flagship's words (at most 21 nodes) do not reach."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def rnd(*shape):
        return torch.rand(shape, generator=g, device=DEVICE)

    loc = -3.0 * rnd(V + 1, kl + 1, N)
    loc[rnd(V + 1, kl + 1, N) < 0.2] = LOG_ZERO
    ent = -3.0 * rnd(V + 1, N)
    ent[rnd(V + 1, N) < 0.7] = LOG_ZERO
    ext = -3.0 * rnd(V + 1, N)
    for a in (loc, ent, ext):
        a[V] = LOG_ZERO
    sidx = torch.randint(0, R, (V + 1, N), generator=g, device=DEVICE,
                         dtype=torch.int32)
    return types.SimpleNamespace(n_words=V, nmax=N, kl=kl, loc=loc,
                                 ent=ent, ext=ext, sidx=sidx)


def check_no_spills(report: str, source: str) -> None:
    """Raise unless every kernel in an nvcc ptxas report keeps its stack
    frame and spills at 0 bytes."""
    frames = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill "
                        r"stores, (\d+) bytes spill loads", report)
    if not frames:
        raise RuntimeError(f"no ptxas report for {source}")
    if any(int(x) for f in frames for x in f):
        raise RuntimeError(f"{source} uses stack or spills: {frames}")


def compare_scan(sk, args):
    """scan_win kernel vs plain on the same arguments -> max |err|."""
    got = sk.scan_core_win(**args)
    want = sk.scan_core_win_plain(**args)
    torch.cuda.synchronize()
    err = max(float((got[i] - want[i]).abs().max()) for i in (0, 2))
    if err > 1e-5:
        raise RuntimeError(f"scan_win scores differ from plain by {err}")
    if not torch.equal(got[1], want[1]):
        n_bad = int((got[1] != want[1]).sum())
        raise RuntimeError(f"scan_win entry frames differ at {n_bad} places")
    return err


def scan_bytes(K, W, N, K1):
    """Least bytes one scan must move: the gathered outprob and the seeds
    read once, the chains' tables and window starts read once, g / beg /
    sv written once."""
    return (K * W * N * 4 + K * W * 4 + K * (K1 + 3) * N * 4 + K * 8
            + 3 * K * W * 4)


def scan_ops(K, W, N, K1):
    """f32 operations of one scan: per node a frame K1 arc adds and K1-1
    compares, the entry add and compare, the emission compare and add,
    the word-end compare and add, and one argmax compare."""
    return K * W * N * (2 * K1 + 7)


def exact_count(res, truths) -> int:
    """Results whose output words equal the generating words."""
    return sum(1 for r, truth in zip(res, truths)
               if [t for t in r.texts if t]
               == [w for w in truth if w not in ("<s>", "</s>")])


def check_results(res, where: str, edges="words") -> None:
    """Every result valid, with a finite score and words; `edges` names
    the field whose first and last entries are <s> and </s> (the words
    of an N-gram dictionary, the output strings of a grammar's; None for
    isolated words)."""
    for r in res:
        ends = getattr(r, edges) if edges else ["<s>", "</s>"]
        if not (r.valid and np.isfinite(r.score) and r.words
                and ends[0] == "<s>" and ends[-1] == "</s>"):
            raise RuntimeError(f"bad {where} result {r}")


def time_step(pk, args, B, N, K1, R):
    """pass1_step's device time, its plain version's and its bound."""
    from julius_tpu_torch.utils.cuda_timing import time_ms
    ms = time_ms(lambda: pk.fused_step(**args))
    plain_ms = time_ms(lambda: pk.fused_step_plain(**args))
    bytes_ms = step_bytes(B, N, K1, R) / HBM_BYTES_PER_S * 1e3
    ops_ms = step_ops(B, N, K1) / F32_OPS_PER_S * 1e3
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def step_ways(pk, args, flush):
    """pass1_step's time two more ways: (b) chain_ms, a chain of 60
    launches each fed the previous one's outputs as pass 1 feeds them,
    one event pair around it; (c) cold_ms, the median of 30 launches each
    after `flush` (an l2_flush: L2 overwritten, outside the events)."""
    from julius_tpu_torch.utils.cuda_timing import chain_ms, time_ms
    return dict(
        chain_ms=chain_ms(
            lambda s: pk.fused_step(**dict(args, score=s[0], ctx=s[1],
                                           prev=s[2])),
            (args["score"], args["ctx"], args["prev"])),
        cold_ms=time_ms(lambda: pk.fused_step(**args), n=30, before=flush))


def time_scan(sk, args, K, W, N, K1, n_plain=50):
    """scan_win's device time, its plain version's and its bound."""
    from julius_tpu_torch.utils.cuda_timing import time_ms
    ms = time_ms(lambda: sk.scan_core_win(**args))
    plain_ms = time_ms(lambda: sk.scan_core_win_plain(**args), n=n_plain,
                       warm=2)
    bytes_ms = scan_bytes(K, W, N, K1) / HBM_BYTES_PER_S * 1e3
    ops_ms = scan_ops(K, W, N, K1) / F32_OPS_PER_S * 1e3
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def pad_windows(wins, lens):
    """Spliced windows -> ([B, T, D] features on the card, [B] lengths)."""
    feats = np.zeros((len(wins), max(lens), wins[0].shape[1]), np.float32)
    for u, w in enumerate(wins):
        feats[u, :w.shape[0]] = w
    return torch.from_numpy(feats).to(DEVICE), np.asarray(lens, np.int32)


def pseudo_bytes(N, S, Q, tables) -> int:
    """Least bytes of one pseudo call over N rows: each row's S senone
    scores read once and its S + Q extended scores written once, the
    member table read once."""
    return (N * (2 * S + Q) + tables.slices.numel()
            + tables.ids.numel()) * 4


#: frames of an envr20k.1pass16 batch that holds a 40-word utterance
#: (999-1107 on the pool's batches, PERF.md §6, PR 21)
PSEUDO_T = 1107


def pseudo_time(card, B=16, T=PSEUDO_T, n_check=64):
    """The pseudo kernel at envr20k's shape: the benchmark's envr20k
    network's own member table (asrbench/configs/envr20k.py), B x T
    rows of S = 4874 scores.  Held bit-equal to the plain version on the
    CPU over the first n_check rows in every scheme, and over every row
    to the ATen path it replaced (gather, scatter_reduce amax and cat on
    the card) under envr20k's `max`; then timed (engine's call: `max`,
    extended rows) beside its byte bound, `best` 3 and `avg`, that ATen
    path, and one pass of the plain version on the host."""
    from asrbench import harness
    from asrbench.program import build_engine
    from julius_tpu_torch.ops import gmm
    from julius_tpu_torch.ops import pseudo_kernel as psk
    from julius_tpu_torch.utils.cuda_timing import time_ms

    cfg = harness.load_json(harness.HERE / "configs" / "envr20k.json")
    builder = harness.load_module(harness.HERE / "configs" / "envr20k.py")
    eng = build_engine(builder.build(cfg, 0), "cpu", enable_pass2=False)
    ps = eng.net.pseudo
    S, Q, L = eng.hmm.n_states, ps.n_set_states, len(ps.members)
    mem, seg, _ = eng._pseudo
    tab = psk.build_tables(ps.members, ps.member_ofs, DEVICE)
    rng = np.random.default_rng(7)
    host = rng.normal(-4.0, 2.0, (B, T, S)).astype(np.float32)
    host[rng.random(host.shape) < 0.05] = LOG_ZERO
    rows = torch.from_numpy(host).to(DEVICE)
    mem_d, seg_d = mem.to(DEVICE), seg.to(DEVICE)

    def kernel(scheme, nbest):
        return lambda: psk.aggregate(rows, tab, scheme, nbest, extend=True)

    def aten():
        return torch.cat([rows, gmm.aggregate_pseudo_plain(
            mem_d, seg_d, Q, rows, "max", 1)], dim=-1)

    with torch.no_grad():
        first = torch.from_numpy(host.reshape(-1, S)[:n_check])
        for scheme, nbest in (("max", 1), ("best", 3), ("best", 5),
                              ("avg", 3)):
            got = psk.aggregate(first.to(DEVICE), tab, scheme, nbest,
                                extend=True).cpu()
            want = torch.cat([first, gmm.aggregate_pseudo_plain(
                mem, seg, Q, first, scheme, nbest)], dim=-1)
            if not torch.equal(got.view(torch.int32),
                               want.view(torch.int32)):
                raise RuntimeError(f"pseudo kernel ({scheme} {nbest}) "
                                   "differs from the plain version")
        if not torch.equal(kernel("max", 1)(), aten()):
            raise RuntimeError("pseudo kernel differs from the ATen path")
        ms = {f"kernel_ms_{s}{n if s == 'best' else ''}":
              time_ms(kernel(s, n), n=20, warm=3)
              for s, n in (("max", 1), ("best", 3), ("avg", 3))}
        aten_ms = time_ms(aten, n=3, warm=1)
        t0 = time.perf_counter()
        gmm.aggregate_pseudo_plain(mem, seg, Q, torch.from_numpy(host),
                                   "max", 1)
        plain_ms = (time.perf_counter() - t0) * 1e3
    N = B * T
    bound_ms = pseudo_bytes(N, S, Q, tab) / HBM_BYTES_PER_S * 1e3
    return dict(batch=B, frames=T, senones=S, pseudo_set_states=Q,
                members=L, table_entries=int(tab.ids.numel()),
                plan=list(psk.plan(S)), **ms, bound_ms=bound_ms,
                share_of_bound=bound_ms / ms["kernel_ms_max"],
                aten_ms=aten_ms, plain_ms=plain_ms, library_ms=None,
                card=card)


def lvcsr_phase(card):
    """The 20k-word tied-triphone configuration: kernels at its shapes,
    then three decodes of bench.py's 32 utterances and a staged one, then
    8 of them with head_rc_dynamic (pass 1's unfused step).  Returns the
    kernels' entries for the JSON line."""
    from julius_tpu_torch.engine import Engine
    from julius_tpu_torch.ops import gmm
    from julius_tpu_torch.ops import pass1_kernel as pk
    from julius_tpu_torch.ops import pseudo_kernel as psk
    from julius_tpu_torch.ops import scan_kernel as sk
    from julius_tpu_torch.ops import word_end_kernel as we
    from julius_tpu_torch.ops.dnn import dnn_scores
    from julius_tpu_torch.search import pass1 as p1
    from julius_tpu_torch.search import pass2_device as p2d
    from julius_tpu_torch.search import pass2_rescan as p2r
    from julius_tpu_torch.tools.synth import lvcsr_engine, make_lvcsr_utts
    from julius_tpu_torch.utils.cuda_timing import l2_flush, time_ms

    t0 = time.perf_counter()
    eng, protos = lvcsr_engine(n_words=20000, hidden=2048, n_layers=5,
                               device=DEVICE)
    heads = eng.iwcd2_tables
    build_s = time.perf_counter() - t0
    dev = eng.dev_net
    N, K1 = dev.loc_lp.shape[1], dev.loc_lp.shape[0]
    S = eng.hmm.n_states
    mem, seg, nq = eng._pseudo
    R = S + nq
    tabs = eng.device_chains
    if not (eng.search_cfg.strict_iwcd2 and heads.n_resolved > 0
            and eng._device_astar_ok()):
        raise RuntimeError("lvcsr_engine does not take the strict device A*")
    truths, wins, lens = make_lvcsr_utts(eng, protos, N_LVCSR, 120, 11,
                                         min_words=5, max_words=10, seed=3)
    feats, lens_np = pad_windows(wins, lens)
    T = feats.shape[1]
    phase("lvcsr_engine", seconds=build_s, nodes=N, arc_span_k=K1 - 1,
          senones=S, pseudo_set_states=nq, pseudo_members=int(mem.shape[0]),
          outprob_columns=R, words=eng.voca.n_words,
          exits=int(dev.exit_nodes.shape[0]), trellis_m=eng.p1_cfg.n_atoms,
          chain_nodes=tabs.nmax, chain_arc_span=tabs.kl,
          iwcd2_classes=int(heads.head_sidx.shape[1]), iwcd2_head=heads.H,
          iwcd2_resolved=heads.n_resolved, utterances=N_LVCSR, frames=T)

    # ---- both kernels against their plain versions at these shapes
    etot = p1.entry_total(dev)
    step_err = 0.0
    for ties in (True, False):
        for padded in (True, False):
            args = step_inputs(dev, etot, N_LVCSR, R, seed=21 + ties,
                               ties=ties, padded=padded)
            step_err = max(step_err, compare_step(pk, args)[0])
    K_A = N_LVCSR * p2d.pops_per_round(eng.p1_cfg.n_atoms)
    W_A = min(p2d.SCAN_WIN, T)
    scan_err = 0.0
    for ties in (True, False):
        args = scan_inputs(tabs, K_A, W_A, T, R, N_LVCSR, 23 + ties, ties,
                           heads=heads)
        scan_err = max(scan_err, compare_scan(sk, args))
    phase("kernel_check", path="lvcsr", kernels=["pass1_step", "scan_win"],
          pass1_step_max_abs_err=step_err, scan_win_max_abs_err=scan_err,
          pass1_step_shape=[N_LVCSR, N, K1 - 1, R],
          scan_win_shape=[K_A, W_A, tabs.nmax, tabs.kl, R])
    args = step_inputs(dev, etot, N_LVCSR, R, seed=25, ties=False,
                       padded=True)
    Np = args["score"].shape[1]
    step_t = time_step(pk, args, N_LVCSR, Np, K1, R)
    ways = step_ways(pk, args, l2_flush(DEVICE))
    phase("kernel_time", path="lvcsr", kernel="pass1_step", batch=N_LVCSR,
          nodes=Np, columns=R, **step_t, **ways,
          cold_share_of_bound=step_t["bound_ms"] / ways["cold_ms"],
          plan=pk._plan(args["score"].device, N_LVCSR, Np, K1)._asdict(),
          library_ms=None, card=card)
    args = scan_inputs(tabs, K_A, W_A, T, R, N_LVCSR, 27, False, heads=heads)
    scan_t = time_scan(sk, args, K_A, W_A, tabs.nmax, tabs.kl + 1)
    phase("kernel_time", path="lvcsr", kernel="scan_win", chains=K_A,
          window=W_A, nodes=tabs.nmax, arc_span_k=tabs.kl, **scan_t,
          library_ms=None, card=card)
    del args

    # ---- the pseudo aggregation on the card against the CPU, then timed
    with torch.no_grad():
        rows = dnn_scores(eng.dnn_scorer, feats[:2, :60]).index_select(
            -1, eng._state_sid)
        cpu_agg = gmm.aggregate_pseudo(
            mem.cpu(), seg.cpu(), nq, rows.cpu(), eng.am_cfg.iwcd_scheme,
            eng.am_cfg.iwcd_nbest)
        card_agg = eng._extend(rows)[..., S:].cpu()
    if not torch.equal(card_agg, cpu_agg):
        raise RuntimeError("pseudo aggregation on the card differs from "
                           "the CPU by "
                           f"{float((card_agg - cpu_agg).abs().max())}")
    pseudo_t = pseudo_time(card)
    phase("kernel_time", path="envr20k", kernel="pseudo", **pseudo_t)

    # ---- three decodes; the counts are read around the third
    spot, retried = [], []
    for _ in range(2):
        eng.decode_features(feats, lens_np)
        spot.append(eng._p2d_spot_ok)
        retried.append(eng.last_pass2["retried"])
    torch.cuda.synchronize()
    pk.LAUNCHES = sk.LAUNCHES = we.LAUNCHES = p2r.CHUNKS = 0
    psk.LAUNCHES = 0
    t0 = time.perf_counter()
    res, spans = traced(eng.decode_features, feats, lens_np)
    e2e_s = time.perf_counter() - t0
    launches, scan_launches, chunks = pk.LAUNCHES, sk.LAUNCHES, p2r.CHUNKS
    we_launches, pseudo_launches = we.LAUNCHES, psk.LAUNCHES
    stats = dict(p2d.LAST_STATS)
    spot.append(eng._p2d_spot_ok)
    retried.append(eng.last_pass2["retried"])
    if launches != T or we_launches != T:
        raise RuntimeError(f"{launches} pass1_step and {we_launches} "
                           f"word_end launches for {T} frames")
    if pseudo_launches != 1:
        raise RuntimeError(f"{pseudo_launches} pseudo launches for one "
                           "decode")
    if scan_launches != stats["replayed"] + chunks or scan_launches == 0:
        raise RuntimeError(f"{scan_launches} scan_win launches for "
                           f"{stats['replayed']} A* rounds run + {chunks} "
                           "chunks")
    check_results(res, "lvcsr")

    # ---- the same decode staged, for where the time goes
    torch.cuda.synchronize()
    walls = {}
    with torch.no_grad():
        t0 = time.perf_counter()
        rows = dnn_scores(eng.dnn_scorer, feats).index_select(
            -1, eng._state_sid)
        torch.cuda.synchronize()
        walls["dnn_wall_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out_ext = eng._extend(rows)
        torch.cuda.synchronize()
        walls["pseudo_wall_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        trellis = eng._pass1(out_ext, lens_np)
        torch.cuda.synchronize()
        walls["pass1_wall_s"] = time.perf_counter() - t0
        with counted_astar(p2d) as staged_astar:
            t0 = time.perf_counter()
            staged = eng._results(trellis, lens_np, out_ext=out_ext)
            p2_s = time.perf_counter() - t0
        states = {}
        graph = graph_vs_eager("lvcsr", dev, eng.ngram_dev, eng.p1_cfg,
                               out_ext, lens_np, got=trellis, card=card,
                               record=lambda: recorded_word_end(states))
        astar = astar_vs_eager("lvcsr", staged_astar, card)
        suffix_path("lvcsr", staged_astar, card)
        stop_every_sweep("lvcsr", staged_astar["calls"][0], card)
        astar_profile("lvcsr", staged_astar["calls"][0], card)
        walls["pass1_eager_wall_s"] = graph["eager_wall_s"]
        frame_profile("lvcsr", eng, out_ext, lens_np, card)
    net = dict(eng.last_pass2)
    staged_s = sum(astar_wall(c["stats"]["spans"])
                   for c in staged_astar["calls"])
    walls.update(astar_wall_s=staged_s, retry_net_wall_s=net["retry_s"],
                 assembly_wall_s=p2_s - staged_s - net["retry_s"],
                 **astar_split(astar))
    if [r.word_ids for r in staged] != [r.word_ids for r in res]:
        raise RuntimeError("staged lvcsr decode differs from decode_features")
    BT = N_LVCSR * T
    agg_ms = time_ms(lambda: eng._extend(rows), n=10, warm=2)
    agg_bytes = pseudo_bytes(BT, S, nq, eng._pseudo_kernel)
    exact = exact_count(res, truths)
    audio_s = float(lens_np.sum()) / 100.0
    phase("lvcsr", utterances=N_LVCSR, frames=T, audio_s=audio_s,
          e2e_wall_s=e2e_s, xrt=audio_s / e2e_s, **walls,
          pseudo_device_ms=agg_ms,
          pseudo_bound_ms=agg_bytes / HBM_BYTES_PER_S * 1e3,
          exact_transcripts=f"{exact}/{N_LVCSR}",
          from_pass2=sum(r.from_pass == 2 for r in res),
          spot_checks_passed_after_each_decode=spot,
          retried_in_each_decode=retried, astar_rounds=stats["rounds"],
          astar_replayed=stats["replayed"], astar_waits=stats["waits"],
          astar_captured=stats["captured"],
          astar_n_pops=stats["n_pops"],
          astar_loop_wall_s=spans["astar.rounds"].total_s,
          kernel_launches=launches, word_end_launches=we_launches,
          scan_win_launches=scan_launches, rescan_chunks=chunks,
          pseudo_launches=pseudo_launches, card=card)
    if exact < N_LVCSR - 2:
        raise RuntimeError(f"only {exact}/{N_LVCSR} exact lvcsr transcripts")

    # ---- head_rc_dynamic: per-context head emission rows in pass 1, so
    # pass 1 takes its unfused step
    t0 = time.perf_counter()
    reng = Engine(eng.hmm, eng.voca, eng.lm, dnn=eng.dnn_params,
                  frontend=eng.fe_cfg, search=eng.search_cfg,
                  am_cfg=dataclasses.replace(eng.am_cfg, head_rc_dynamic=True),
                  device=DEVICE)
    build_s = time.perf_counter() - t0
    if reng.dev_net.rc_head is None:
        raise RuntimeError("lvcsr_rc_dynamic: no per-context head rows")
    fields, rc_entries = unfused_run("lvcsr_rc_dynamic", reng, eng,
                                     feats[:N_RC], lens_np[:N_RC],
                                     truths[:N_RC], card)
    phase("unfused_lvcsr", path="lvcsr_rc_dynamic", engine_build_s=build_s,
          head_rows=int(reng.dev_net.rc_sidx.shape[0] // reng.dev_net.rc_C),
          classes=reng.dev_net.rc_C, **fields, card=card)
    del reng
    return kernel_entries("lvcsr", {
        "pass1_step": dict(launches=launches, max_abs_err=step_err,
                           **step_t),
        "scan_win": dict(launches=scan_launches, max_abs_err=scan_err,
                         **scan_t),
        "word_end": word_end_path("lvcsr", states["word_end"], we_launches,
                                  card, phases=True)}) + rc_entries


def waveform_phase(eng, card, step_t):
    """The flagship's waveform path at bench.py's shape, its front end
    against the CPU front end, and recognize_batch on two short
    waveforms.  Returns the kernel's entry for the JSON line."""
    from julius_tpu_torch.frontend import mfcc as fe
    from julius_tpu_torch.ops import pass1_kernel as pk
    from julius_tpu_torch.ops import scan_kernel as sk
    from julius_tpu_torch.ops import word_end_kernel as we

    L = int(WAVE_S * 16000)
    g = torch.Generator(device=DEVICE).manual_seed(0)
    wave = 2000.0 * torch.randn((N_WAVE, L), generator=g, device=DEVICE)
    lengths = torch.full((N_WAVE,), L, dtype=torch.int32, device=DEVICE)
    T = fe.num_frames(L, eng.fe_cfg)
    with torch.no_grad():
        eng._decode_device(wave, lengths)                  # warm-up
        torch.cuda.synchronize()
        pk.LAUNCHES = sk.LAUNCHES = we.LAUNCHES = 0
        t0 = time.perf_counter()
        trellis, nfr, out_ext = eng._decode_device(wave, lengths)
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
        launches, scan_launches = pk.LAUNCHES, sk.LAUNCHES
        we_launches = we.LAUNCHES
        if launches != T or we_launches != T or scan_launches:
            raise RuntimeError(f"{launches} pass1_step, {we_launches} "
                               f"word_end and {scan_launches} scan_win "
                               f"launches for {T} frames")
        if not (nfr == T).all():
            raise RuntimeError(f"frame counts {nfr.tolist()}, expected {T}")
        if not (torch.isfinite(out_ext).all()
                and (trellis.word[:, -1] >= 0).any(dim=1).all()):
            raise RuntimeError("waveform path: non-finite outprobs or an "
                               "utterance with no word end at its last frame")
        n_iter = 3
        t0 = time.perf_counter()
        for _ in range(n_iter):
            eng._decode_device(wave, lengths)
        torch.cuda.synchronize()
        p1_wall = (time.perf_counter() - t0) / n_iter
        # staged: front end + splice, DNN, pass 1
        t0 = time.perf_counter()
        feats, mask = eng._features(wave, lengths)
        torch.cuda.synchronize()
        fe_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out_ext = eng._outprob(feats)
        torch.cuda.synchronize()
        dnn_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        staged = eng._pass1(out_ext, mask.sum(dim=1).int())
        torch.cuda.synchronize()
        p1_s = time.perf_counter() - t0
        states = {}
        graph = graph_vs_eager("waveform", eng.dev_net, eng.ngram_dev,
                               eng.p1_cfg, out_ext, mask.sum(dim=1),
                               got=staged, card=card,
                               record=lambda: recorded_word_end(states))
        del out_ext, trellis, staged
        # the front end on the card against the CPU front end
        cpu_feats, cpu_mask = fe.extract_features(
            wave.cpu(), lengths.cpu(), eng.fe_tables)
        card_feats, card_mask = fe.extract_features(wave, lengths,
                                                    eng.fe_tables)
        card_feats = card_feats.cpu()
    fe_err = float((card_feats - cpu_feats).abs().max())
    if not (torch.equal(card_mask.cpu(), cpu_mask)
            and torch.allclose(card_feats, cpu_feats, atol=1e-4, rtol=1e-4)):
        raise RuntimeError(f"front end on the card vs CPU: max err {fe_err}")
    # recognize_batch end to end on two short waveforms
    short = np.zeros((2, 16000), np.float32)
    rng = np.random.default_rng(5)
    short[0] = 2000.0 * rng.standard_normal(16000)
    short[1, :9600] = 2000.0 * rng.standard_normal(9600)
    rb = eng.recognize_batch(short, [16000, 9600])
    for r in rb:
        if not (r.valid and np.isfinite(r.score) and r.words):
            raise RuntimeError(f"bad recognize_batch result {r}")
    phase("waveform", utterances=N_WAVE, seconds_each=WAVE_S, frames=T,
          decode_device_wall_s=p1_wall, first_timed_call_s=one_s,
          pass1_only_xrt=N_WAVE * WAVE_S / p1_wall,
          frontend_splice_wall_s=fe_s, dnn_wall_s=dnn_s, pass1_wall_s=p1_s,
          pass1_eager_wall_s=graph["eager_wall_s"],
          pass1_kernel_s=launches * step_t["ms"] * 1e-3,
          kernel_launches=launches, word_end_launches=we_launches,
          frontend_card_vs_cpu_max_err=fe_err,
          recognize_batch=[dict(words=r.words, score=r.score,
                                from_pass=r.from_pass) for r in rb],
          card=card)
    return kernel_entries("waveform", {
        "pass1_step": dict(step_t, launches=launches),
        "word_end": word_end_path("waveform", states["word_end"],
                                  we_launches, card)})


def gauss_cost(BT, D, G):
    """(f32 operations, least bytes) of gauss_scores on [BT, D] frames:
    the product [x, x*x] @ [a; -half_iv] of 2 * BT * 2D * G operations,
    x * x and the bias's add; x, the [2D, G] table and c read once, the
    [BT, G] scores written once."""
    return (4 * BT * D * G + BT * D + 2 * BT * G,
            4 * (BT * D + 2 * D * G + G + BT * G))


def mixture_cost(BT, S, M):
    """(f32 operations, least bytes) of mixture_scores over [BT, S, M]
    components: per component the weight's add, the max's compare, the
    shift, the exp and the sum's add; per state a log, an add and the
    floor; the Gaussian scores read once (every component reads a
    distinct Gaussian), the int64 ids and f32 weights read once, the
    [BT, S] scores written once."""
    return (5 * BT * S * M + 3 * BT * S,
            4 * BT * S * M + 12 * S * M + 4 * BT * S)


@contextlib.contextmanager
def kept_loops():
    """Keep every stream chunk (`pass1_stream_chunk`) and alignment
    Viterbi (`viterbi_chain`) call of the block, with its inputs, its
    result, the graph replays it made and the captures it took: a graph
    runs the loop body from replays, so `loops_vs_eager` runs the body's
    eager oracle on the same inputs after the block.  Each alignment's
    wall is split into the host's chain build, the outprob (to the
    Viterbi's start, synchronised), the Viterbi (synchronised), the read
    back and the host backtrace.  A stream's segment-end flush
    (`pass1_stream_finalize`, one word-end launch outside any graph)
    keeps its arguments.  Yields {"streams": [...], "aligns": [...],
    "finals": [...]}."""
    from julius_tpu_torch.search import align as al
    from julius_tpu_torch.search import pass1 as p1

    kept = {"streams": [], "aligns": [], "finals": []}
    replays, marks = [0], {}
    real = (p1.pass1_stream_chunk, al.viterbi_chain, al.build_chain,
            al.align_backtrace, torch.cuda.CUDAGraph.replay,
            p1.pass1_stream_finalize)

    def replay(self):
        replays[0] += 1
        return real[4](self)

    def chunk(dev, ngram, cfg, state, out_chunk, n_valid):
        n0, c0, s0 = replays[0], dev.graphs.captures, dev.graphs.capture_s
        got = real[0](dev, ngram, cfg, state, out_chunk, n_valid)
        kept["streams"].append(dict(
            args=(dev, ngram, cfg, state, out_chunk, n_valid), got=got,
            replays=replays[0] - n0, captured=dev.graphs.captures - c0,
            capture_s=dev.graphs.capture_s - s0))
        return got

    def finalize(dev, ngram, cfg, state):
        kept["finals"].append((dev, ngram, cfg, p1.Pass1State(
            *[x.clone() for x in state])))
        return real[5](dev, ngram, cfg, state)

    def build_chain(*a, **kw):
        t0 = time.perf_counter()
        chain = real[2](*a, **kw)
        marks["chain"] = (time.perf_counter() - t0, time.perf_counter())
        return chain

    def viterbi(*a, graphs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n0, c0, s0 = replays[0], graphs.captures, graphs.capture_s
        got = real[1](*a, graphs=graphs)
        torch.cuda.synchronize()
        marks["viterbi"] = time.perf_counter()
        chain_s, chain_end = marks.pop("chain")
        kept["aligns"].append(dict(
            args=a, graphs=graphs, got=got, replays=replays[0] - n0,
            captured=graphs.captures - c0, capture_s=graphs.capture_s - s0,
            build_chain_s=chain_s, outprob_s=t0 - chain_end,
            viterbi_s=marks["viterbi"] - t0))
        return got

    def backtrace(*a, **kw):
        t0 = time.perf_counter()
        out = real[3](*a, **kw)
        kept["aligns"][-1].update(readback_s=t0 - marks.pop("viterbi"),
                                  backtrace_s=time.perf_counter() - t0)
        return out

    p1.pass1_stream_chunk, al.viterbi_chain = chunk, viterbi
    al.build_chain, al.align_backtrace = build_chain, backtrace
    torch.cuda.CUDAGraph.replay = replay
    p1.pass1_stream_finalize = finalize
    try:
        yield kept
    finally:
        p1.pass1_stream_chunk, al.viterbi_chain, al.build_chain, \
            al.align_backtrace, torch.cuda.CUDAGraph.replay, \
            p1.pass1_stream_finalize = real


#: every stream_graph and align_graph line of the run, for the summaries
STREAM_LINES, ALIGN_LINES = [], []


def timed(fn):
    """fn() on the card, synchronised -> (its result, host seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def same_tensors(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def stream_vs_eager(label, calls, card, record=None):
    """Each kept stream chunk of one path (`kept_loops`), run again
    graphed (replays of the network's cached graph) and as its eager
    oracle (the same chunk row once a row from Python) on the same
    inputs: the atoms and the state after the chunk must be bit-equal to
    the run's, and the run must have made one graph launch a chunk row.
    The oracle runs inside `record` (a context) where given; the
    word-end launches of both runs are taken back out of LAUNCHES.
    Prints a stream_graph line: ms a block and a frame of both, the
    run's graph launches a row, captures and their seconds; returns its
    fields."""
    from julius_tpu_torch.ops import word_end_kernel as we
    from julius_tpu_torch.search import pass1 as p1

    per, w0 = [], we.LAUNCHES
    for c in calls:
        g, g_s = timed(lambda: p1.pass1_stream_chunk(*c["args"]))
        with record() if record else contextlib.nullcontext():
            e, e_s = timed(lambda: p1.pass1_stream_chunk(*c["args"],
                                                         eager=True))
        per.append(dict(rows=c["args"][4].shape[0], valid=c["args"][5],
                        graphed_s=g_s, eager_s=e_s,
                        equal=all(same_tensors(x[i], c["got"][i])
                                  for x in (g, e) for i in (0, 1))))
    we.LAUNCHES = w0

    def total(k, src=per):
        return sum(x[k] for x in src)

    rows, n = total("rows"), max(len(per), 1)
    fields = dict(
        path=label, chunks=len(per), rows=rows, valid_rows=total("valid"),
        short_chunks=sum(x["valid"] < x["rows"] for x in per),
        graph_launches=total("replays", calls),
        graph_launches_per_row=total("replays", calls) / max(rows, 1),
        captures=total("captured", calls),
        capture_s=total("capture_s", calls),
        graphed_ms_per_block=total("graphed_s") * 1e3 / n,
        eager_ms_per_block=total("eager_s") * 1e3 / n,
        graphed_ms_per_frame=total("graphed_s") * 1e3 / max(rows, 1),
        eager_ms_per_frame=total("eager_s") * 1e3 / max(rows, 1),
        eager_over_graphed=total("eager_s") / max(total("graphed_s"), 1e-9),
        bit_equal=all(x["equal"] for x in per))
    phase("stream_graph", **fields, card=card)
    STREAM_LINES.append(fields)
    if not per or not fields["bit_equal"] \
            or fields["graph_launches"] != rows:
        raise RuntimeError(f"{label}: the graphed stream chunk differs from "
                           f"its eager oracle: {fields}")
    return fields


def align_vs_eager(label, calls, card):
    """Each kept alignment Viterbi of one path (`kept_loops`), run again
    graphed (replays from the engine's cache) and as its eager oracle
    (the same frame once a frame from Python at the chain's own sizes)
    on the same inputs: score, backpointers and best node bit-equal to
    the run's; the run must have made one graph launch a frame and no
    more captures than it had buckets of chain sizes.  Prints an
    align_graph line: ms an utterance and a frame of both, buckets
    ([nodes, in-arcs, frames] as the graphs are keyed),
    captures and their seconds, and the run's alignment wall split into
    build_chain (host), outprob, Viterbi, read back and backtrace
    (host), ms an utterance each; returns its fields."""
    from julius_tpu_torch.search import align as al

    per, buckets = [], set()
    for c in calls:
        a = c["args"]
        (N, Din), T = a[1].shape, a[5].shape[0]
        n_cap, t_cap = al.buckets(N, T)
        buckets.add((n_cap, Din, t_cap))
        g, g_s = timed(lambda: al.viterbi_chain(*a, graphs=c["graphs"]))
        e, e_s = timed(lambda: al.viterbi_chain(*a, eager=True))
        per.append(dict(frames=max(0, min(T, int(a[6])) - 1), graphed_s=g_s,
                        eager_s=e_s, equal=(same_tensors(g, c["got"])
                                            and same_tensors(e, c["got"]))))

    def total(k, src=per):
        return sum(x[k] for x in src)

    n, frames = max(len(per), 1), max(total("frames"), 1)
    fields = dict(
        path=label, utterances=len(per), frames=total("frames"),
        buckets=sorted(list(b) for b in buckets),
        captures=total("captured", calls),
        capture_s=total("capture_s", calls),
        graph_launches=total("replays", calls),
        graph_launches_per_frame=total("replays", calls) / frames,
        graphed_ms_per_utterance=total("graphed_s") * 1e3 / n,
        eager_ms_per_utterance=total("eager_s") * 1e3 / n,
        graphed_ms_per_frame=total("graphed_s") * 1e3 / frames,
        eager_ms_per_frame=total("eager_s") * 1e3 / frames,
        eager_over_graphed=total("eager_s") / max(total("graphed_s"), 1e-9),
        wall_split_ms_per_utterance={
            k[:-2]: total(k, calls) * 1e3 / n
            for k in ("build_chain_s", "outprob_s", "viterbi_s",
                      "readback_s", "backtrace_s")},
        bit_equal=all(x["equal"] for x in per))
    phase("align_graph", **fields, card=card)
    ALIGN_LINES.append(fields)
    if not per or not fields["bit_equal"] \
            or fields["graph_launches"] != total("frames") \
            or fields["captures"] > len(buckets):
        raise RuntimeError(f"{label}: the graphed alignment Viterbi differs "
                           f"from its eager oracle, or captured more than "
                           f"once a bucket: {fields}")
    return fields


def loops_vs_eager(label, kept, card, record=None):
    """The stream_graph and align_graph lines of one path's kept loops
    (`kept_loops`), for the kinds it ran; the stream chunks' oracles run
    inside `record` where given."""
    if kept["streams"]:
        stream_vs_eager(label, kept["streams"], card, record)
    if kept["aligns"]:
        align_vs_eager(label, kept["aligns"], card)


KEEP_CALL = 64    # besides the first, the call of a shape whose arguments are kept


def keep_calls(store, name, fn, plain, shape_of):
    """`fn` wrapped so that each call's shape is counted in store[name]
    and the arguments of the first and the KEEP_CALL-th call at each
    shape are copied: store[name] = {shape: [count, [args, ...]]}, the
    tensors of a plain tuple among them too (a state set the call
    writes, which the loop goes on to overwrite).  The arguments are
    named as those of `plain`, the plain version, whose signature the
    wrapper shares."""
    params = list(inspect.signature(plain).parameters)

    def copy(v):
        if torch.is_tensor(v):
            return v.clone()
        if type(v) is tuple:
            return tuple(copy(x) for x in v)
        return v

    def wrapped(*a, **kw):
        args = dict(zip(params, a), **kw)
        entry = store[name].setdefault(shape_of(args), [0, []])
        entry[0] += 1
        if entry[0] in (1, KEEP_CALL):
            entry[1].append({k: copy(v) for k, v in args.items()})
        return fn(*a, **kw)
    return wrapped


def word_end_key(dev, ngram, cfg, score, winner) -> tuple:
    """The shape a word_end call is recorded by: [B, N, Ex, M, LM (0
    none, 1 narrow 2-gram keys, 2 wide), factoring, winner asked]."""
    lm = 0 if not (cfg.use_lm and ngram is not None) else 1 + ngram.wide
    return (*score.shape, int(dev.exit_nodes.shape[0]), cfg.n_atoms, lm,
            int(cfg.factoring), int(bool(winner)))


@contextlib.contextmanager
def recorded_word_end(store):
    """Record the word-end kernel's calls into store["word_end"]
    (`keep_calls`) while the block runs; yields the store."""
    from julius_tpu_torch.ops import word_end_kernel as we

    store.setdefault("word_end", {})
    real = we.word_end
    we.word_end = keep_calls(
        store, "word_end", real, we.word_end_plain,
        lambda a: word_end_key(a["dev"], a["ngram"], a["cfg"], a["score"],
                               a.get("t") is not None))
    try:
        yield store
    finally:
        we.word_end = real


@contextlib.contextmanager
def recorded_calls(pk, sk, p2d, scan_mod):
    """Wrap both kernels where the decode looks them up: each call's
    shape is counted, and the arguments of the first and the KEEP_CALL-th
    call at each shape are copied.  Pass 1 runs its frame step from a
    CUDA graph, where pass1_step's wrapper is called only at capture, so
    each pass1_batch call is kept instead (its inputs and the graphed
    trellis) and `path_kernels` records pass1_step's calls from its
    eager oracle on the same batch.  Yields calls[kernel] = {shape:
    [count, [args, ...]]}, with calls["batches"] the kept pass1_batch
    calls and calls["record_step"] the context that records pass1_step;
    the wrappers' own launch counts are untouched.  The word-end stage
    (ops/word_end_kernel.py `word_end`) runs in the same graphs, so
    record_step records its calls too (calls["word_end"]), from the eager
    oracles of the batches and of the stream chunks, and from the
    segment-end flushes kept by kept_loops.  The device A*'s
    round runs from a CUDA graph too, so its scans are recorded from its
    eager oracle likewise: calls["astar"] is the block's
    `counted_astar`, and calls["record_astar"] the context that records
    its scans.  calls["loops"] is the block's `kept_loops` (its stream
    chunks and alignment Viterbis, run from graphs too)."""
    from julius_tpu_torch.search import pass1 as p1

    calls = {"pass1_step": {}, "scan_win": {}, "word_end": {},
             "batches": []}

    def wrap(name, fn, shape_of):
        plain = pk.fused_step_plain if name == "pass1_step" \
            else sk.scan_core_win_plain
        return keep_calls(calls, name, fn, plain, shape_of)

    def step_shape(a):
        return (*a["score"].shape, a["loc_lp"].shape[0], a["row"].shape[-1])

    def scan_shape(a):
        K, K1, N = a["loc"].shape
        return (K, a["seed"].shape[1], N, K1, *a["out_ext"].shape)

    def batch(dev, ngram, cfg, out_ext, n_frames, use_kernel=True,
              eager=False):
        tr = real[3](dev, ngram, cfg, out_ext, n_frames,
                     use_kernel=use_kernel, eager=eager)
        calls["batches"].append(dict(
            dev=dev, ngram=ngram, cfg=cfg, out_ext=out_ext.clone(),
            n_frames=torch.as_tensor(n_frames).clone(),
            use_kernel=use_kernel, got=[a.clone() for a in tr]))
        return tr

    @contextlib.contextmanager
    def record_step():
        pk.fused_step = wrap("pass1_step", real[0], step_shape)
        try:
            with recorded_word_end(calls):
                yield
        finally:
            pk.fused_step = real[0]

    @contextlib.contextmanager
    def record_astar():
        p2d.scan_core_win = wrap("scan_win", real[1], scan_shape)
        try:
            yield
        finally:
            p2d.scan_core_win = real[1]

    calls["record_step"] = record_step
    calls["record_astar"] = record_astar
    real = pk.fused_step, p2d.scan_core_win, scan_mod.scan_core_win, \
        p1.pass1_batch
    scan_mod.scan_core_win = wrap("scan_win", real[2], scan_shape)
    p1.pass1_batch = batch
    try:
        with counted_astar(p2d) as calls["astar"], \
                kept_loops() as calls["loops"]:
            yield calls
    finally:
        scan_mod.scan_core_win, p1.pass1_batch = real[2:]


#: every pass1_graph line of the run, for the summary before the kernels
GRAPH_LINES = []


def graph_vs_eager(label, dev, ngram, cfg, out_ext, n_frames,
                   use_kernel=True, got=None, card=None, record=None):
    """pass1_batch on one batch, graphed (replays of its captured frame
    step) and as its eager oracle (the same step once a frame from
    Python), each timed by the host clock around a synchronised run: the
    two trellises, and `got` (the trellis the path produced) where
    given, must be equal bit for bit, with equal kernel launches (and
    one word-end launch a frame in each).  The oracle runs inside
    `record` (a context) where given; the launches of both runs are
    taken back out of LAUNCHES.  Prints a pass1_graph line
    (with the network's graphs captured so far and their capture
    seconds) and returns its fields."""
    from julius_tpu_torch.ops import pass1_kernel as pk
    from julius_tpu_torch.ops import word_end_kernel as we
    from julius_tpu_torch.search import pass1 as p1

    B, T = out_ext.shape[:2]
    nfr = torch.as_tensor(n_frames).to(out_ext.device, torch.int32)
    n0, w0, captures = pk.LAUNCHES, we.LAUNCHES, dev.graphs.captures
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graphed = p1.pass1_batch(dev, ngram, cfg, out_ext, nfr,
                             use_kernel=use_kernel)
    torch.cuda.synchronize()
    graphed_s = time.perf_counter() - t0
    n_graphed, w_graphed = pk.LAUNCHES - n0, we.LAUNCHES - w0
    with record() if record else contextlib.nullcontext():
        t0 = time.perf_counter()
        eager = p1.pass1_batch(dev, ngram, cfg, out_ext, nfr,
                               use_kernel=use_kernel, eager=True)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
    n_eager = pk.LAUNCHES - n0 - n_graphed
    w_eager = we.LAUNCHES - w0 - w_graphed
    pk.LAUNCHES, we.LAUNCHES = n0, w0
    same = all(torch.equal(a, b) for a, b in zip(graphed, eager))
    same_run = got is None or all(torch.equal(a, b)
                                  for a, b in zip(got, eager))
    fields = dict(
        path=label, batch=B, frames=T,
        fused=bool(use_kernel and p1.fused_ok(dev, cfg)),
        graphed_wall_s=graphed_s, eager_wall_s=eager_s,
        graphed_ms_per_frame=graphed_s * 1e3 / T,
        eager_ms_per_frame=eager_s * 1e3 / T,
        eager_over_graphed=eager_s / graphed_s,
        launches_graphed=n_graphed, launches_eager=n_eager,
        word_end_graphed=w_graphed, word_end_eager=w_eager,
        captured_in_this_call=dev.graphs.captures - captures,
        network_graphs=dev.graphs.captures,
        network_capture_s=dev.graphs.capture_s,
        bit_equal=same, equal_to_the_run=same_run)
    phase("pass1_graph", **fields, card=card)
    GRAPH_LINES.append(fields)
    if not (same and same_run) or n_graphed != n_eager \
            or not w_graphed == w_eager == T:
        raise RuntimeError(f"{label}: graphed pass 1 differs from its eager "
                           f"oracle: {fields}")
    return fields


def path_kernels(label, calls, launches, eng, card):
    """Each kernel one run launched, at the shapes the run gave it
    (`recorded_calls`; pass1_step's from the eager oracle of each of the
    run's pass1_batch calls, `graph_vs_eager`, whose trellis must equal
    the graphed run's; the device A*'s scans from the eager oracle of
    each of its run_batch calls, `astar_vs_eager`, with the graph's
    gated rounds past the end added at that shape): per shape, held
    against the plain version on the run's own kept arguments and on
    integer-valued inputs at that shape over the run's engine tables,
    then timed on the kept arguments beside the plain version and the
    bound.  -> {kernel: entry fields},
    the times and bound the launch-weighted mean over the run's shapes;
    a kernel the run never called has no entry."""
    from julius_tpu_torch.ops import pass1_kernel as pk
    from julius_tpu_torch.ops import scan_kernel as sk
    from julius_tpu_torch.search import pass1 as p1
    from julius_tpu_torch.search import pass2_device as p2d

    dev = eng.dev_net
    # the stream chunks and alignment Viterbis against their oracles
    kept = calls.pop("loops")
    loops_vs_eager(label, kept, card, record=calls["record_step"])
    # a stream's segment-end flushes (a word-end launch each), and the
    # eager first row that each capture of its chunk step ran
    with calls["record_step"]():
        for args in kept["finals"]:
            p1.pass1_stream_finalize(*args)
    for c in kept["streams"]:
        if c["captured"]:
            d, ng, cfg, state = c["args"][:4]
            key = word_end_key(d, ng, cfg, state.score,
                               p1._scalar_winner(d, ng, cfg))
            calls["word_end"][key][0] += c["captured"]
    # pass1_step's calls, from the eager oracle of each graphed batch
    for b in calls.pop("batches"):
        graph_vs_eager(label, b["dev"], b["ngram"], b["cfg"], b["out_ext"],
                       b["n_frames"], b["use_kernel"], got=b["got"],
                       card=card, record=calls["record_step"])
    # the A*'s scans, from the eager oracle of each graphed call, plus
    # the gated rounds the graph ran past the end (same shape)
    astar = calls.pop("astar")
    if astar["calls"]:
        astar_vs_eager(label, astar, card, record=calls["record_astar"])
        suffix_path(label, astar, card)
    for c in astar["calls"]:
        tabs, out_ext = c["args"][1], c["args"][5]
        B, T, R = out_ext.shape
        key = (B * c["stats"]["P"], min(p2d.SCAN_WIN, T), tabs.nmax,
               tabs.kl + 1, B, T, R)
        calls["scan_win"][key][0] += c["stats"]["replayed"] - \
            c["stats"]["rounds"]
    out = {}
    for name in ("pass1_step", "scan_win"):
        if not calls[name] and not launches[name]:
            continue            # a kernel this path does not run
        shapes = []
        for key, (count, kept) in sorted(calls[name].items()):
            if name == "pass1_step":
                B, N, K1, R = key
                err = max(compare_step(pk, a)[0] for a in kept)
                ties = step_inputs(dev, p1.entry_total(dev), B, R, seed=41,
                                   ties=True)
                err = max(err, compare_step(pk, ties)[0])
                t = time_step(pk, kept[-1], B, N, K1, R)
            else:
                K, W, N, K1, B, T, R = key
                tabs = eng.device_chains
                if N != tabs.nmax:
                    raise RuntimeError(f"{label}: scan_win on {N}-node "
                                       f"chains, tables of {tabs.nmax}")
                err = max(compare_scan(sk, a) for a in kept)
                ties = scan_inputs(tabs, K, W, T, R, B, 43, True)
                err = max(err, compare_scan(sk, ties))
                t = time_scan(sk, kept[-1], K, W, N, K1, n_plain=5)
            shapes.append(dict(shape=list(key), launches=count,
                               max_abs_err=err, **t))
        n = sum(x["launches"] for x in shapes)
        if n != launches[name]:
            raise RuntimeError(f"{label}: {n} {name} calls recorded for "
                               f"{launches[name]} launches")

        def mean(k):
            return sum(x[k] * x["launches"] for x in shapes) / n

        by = {b: sum(x["bound_ms"] * x["launches"] for x in shapes
                     if x["bound_by"] == b) for b in ("bytes", "operations")}
        out[name] = dict(
            launches=n, max_abs_err=max(x["max_abs_err"] for x in shapes),
            ms=mean("ms"), plain_ms=mean("plain_ms"),
            bound_ms=mean("bound_ms"), bound_by=max(by, key=by.get),
            n_shapes=len(shapes))
        phase("kernel_path", path=label, kernel=name,
              shape_is=("[B, N, K+1, R]" if name == "pass1_step"
                        else "[K, W, N, K+1, B, T, R]"),
              shapes=shapes, **out[name], library_ms=None, card=card)
    if calls["word_end"] or launches.get("word_end"):
        out["word_end"] = word_end_path(label, calls["word_end"],
                                        launches.get("word_end", 0), card)
    return out


def bits_equal(a, b) -> bool:
    """Equal dtypes and shapes, and floats equal bit for bit."""
    if a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def word_end_fields(out):
    """A word_end result, (atoms, winner or None), as a flat list."""
    return [*out[0], *(out[1] or ())]


def word_end_bytes(B, Ex, k, M, lm, winner):
    """Least bytes one word-end call must move: each row's exit scores
    (4 B an exit, gathered) and the exits' node ids and ln p once; for
    each of a row's k candidates its ctx and prev, its word, LM word,
    unigram and transparency, and with an LM its ctx_info row and the
    8 probe rows of the 2-gram table (2 words a row, 3 with wide keys);
    the [B, M] atoms written once, and the [B] winner and the frame
    index where asked."""
    probe = 0 if lm == 0 else 8 + 8 * 4 * (1 + lm)
    return (B * Ex * 4 + Ex * 12 + B * k * (8 + 13 + probe) + B * M * 24
            + (B * 12 + 4 if winner else 0))


def word_end_ops(B, Ex, k):
    """Operations of one call, as the plain version counts them: an add
    a gathered exit and, for each candidate, 8 probe compares and about
    6 adds, multiplies and compares of the correction."""
    return B * (Ex + 14 * k)


def word_end_path(label, recorded, launches, card, phases=False):
    """The word-end kernel on one path, at the states the path gave it
    (`recorded_word_end`: each shape's call count and kept arguments).
    Each kept call is held bit-equal to word_end_plain (a word_end_check
    line); then each shape is timed on its last kept call: (a) ms, the
    median of 60 launches, (c) cold_ms, of 30 launches each after an
    l2_flush, the plain version, and torch.topk on the same [B, Ex] exit
    scores for the first selection alone (topk_ms: no one PyTorch call
    computes the whole stage, so library_ms is null), beside the bound,
    with the cluster plan (C, threads) the wrapper took there, and with
    `phases` the phase split of 40 launches of the phase-stamp build on
    the same call (tools/time_word_end.py `phase_split`).  Raises unless
    the recorded calls equal the path's launches.  -> entry fields, the
    times and bound launch-weighted over the shapes."""
    from julius_tpu_torch.ops import word_end_kernel as we
    from julius_tpu_torch.tools import time_word_end as twe
    from julius_tpu_torch.utils.cuda_timing import l2_flush, time_ms

    n = sum(count for count, _ in recorded.values())
    if n != launches or n == 0:
        raise RuntimeError(f"{label}: {n} word_end calls recorded for "
                           f"{launches} launches")
    flush = l2_flush(DEVICE)
    shapes, err = [], 0.0
    for key, (count, kept) in sorted(recorded.items()):
        for a in kept:
            got = word_end_fields(we.word_end(**a))
            want = word_end_fields(we.word_end_plain(**a))
            torch.cuda.synchronize()
            if not all(bits_equal(x, y) for x, y in zip(got, want)):
                raise RuntimeError(f"{label}: word_end differs from its "
                                   f"plain version at {key}")
            err = max([err] + [float((x - y).abs().max()) for x, y in
                               zip(got, want) if x.dtype == torch.float32])
        a = kept[-1]
        B, _, Ex, M, lm, _, winner = key
        k = min(2 * M, Ex)
        sc_all = a["score"][:, a["dev"].exit_nodes] + a["dev"].exit_nlp
        t = dict(ms=time_ms(lambda: we.word_end(**a)),
                 cold_ms=time_ms(lambda: we.word_end(**a), n=30,
                                 before=flush),
                 plain_ms=time_ms(lambda: we.word_end_plain(**a), n=20,
                                  warm=2),
                 topk_ms=time_ms(lambda: torch.topk(sc_all, k)))
        bytes_ms = word_end_bytes(B, Ex, k, M, lm, winner) \
            / HBM_BYTES_PER_S * 1e3
        ops_ms = word_end_ops(B, Ex, k) / F32_OPS_PER_S * 1e3
        if phases:
            t["phases"] = twe.phase_split(twe.phase_lib(), a)
        shapes.append(dict(shape=list(key), launches=count,
                           states_checked=len(kept),
                           plan=list(we.cluster_plan(B, Ex)), **t,
                           bound_ms=max(bytes_ms, ops_ms),
                           bound_by="bytes" if bytes_ms >= ops_ms
                           else "operations"))
    del flush
    phase("word_end_check", path=label,
          shape_is="[B, N, Ex, M, lm, factoring, winner]",
          shapes=[{k: x[k] for k in ("shape", "launches", "states_checked")}
                  for x in shapes], bit_equal=True, max_abs_err=err,
          card=card)

    def mean(f):
        return sum(x[f] * x["launches"] for x in shapes) / n

    by = {b: sum(x["bound_ms"] * x["launches"] for x in shapes
                 if x["bound_by"] == b) for b in ("bytes", "operations")}
    out = dict(launches=n, max_abs_err=err, ms=mean("ms"),
               cold_ms=mean("cold_ms"), plain_ms=mean("plain_ms"),
               topk_ms=mean("topk_ms"), bound_ms=mean("bound_ms"),
               bound_by=max(by, key=by.get), n_shapes=len(shapes))
    phase("kernel_path", path=label, kernel="word_end",
          shape_is="[B, N, Ex, M, lm, factoring, winner]", shapes=shapes,
          **out, library_ms=None, card=card)
    return out


def run_cli(recognize, argv, results):
    """recognize.main(argv) on the card, its standard output captured and
    each engine's results appended to `results` (a result callback) ->
    (output lines, wall seconds, the engines it built)."""
    import io

    real = recognize.create_engines
    built = []

    def engines_with_callback(*args, **kw):
        engines = real(*args, **kw)
        for eng in engines:
            eng.callbacks.add("result", results.append)
        built.extend(engines)
        return engines

    buf = io.StringIO()
    recognize.create_engines = engines_with_callback
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = recognize.main(argv, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        recognize.create_engines = real
    if rc != 0:
        raise RuntimeError(f"recognize.main returned {rc}")
    return buf.getvalue().splitlines(), wall, built


def cli_phase(card, task_dir):
    """The julius command line from model files: a GMM-HMM task of the
    flagship's width written to `task_dir`, both kernels and the GMM
    scorer on the engine loaded from those files, then five runs of
    recognize.main.  Returns the kernels' entries for the JSON line and
    the task's files."""

    from julius_tpu_torch import fusion
    from julius_tpu_torch.io.htk_param import read_htk_param
    from julius_tpu_torch.jconf import parse_jconf
    from julius_tpu_torch.ops import gmm
    from julius_tpu_torch.ops import pass1_kernel as pk
    from julius_tpu_torch.ops import scan_kernel as sk
    from julius_tpu_torch.ops import word_end_kernel as we
    from julius_tpu_torch.search import pass1 as p1
    from julius_tpu_torch.search import pass2_device as p2d
    from julius_tpu_torch.search import pass2_rescan as p2r
    from julius_tpu_torch.search import scan as scan_mod
    from julius_tpu_torch.tools import recognize
    from julius_tpu_torch.tools.synth import (write_gmm_task,
                                              write_grammar_task)
    from julius_tpu_torch.utils.cuda_timing import time_ms

    with contextlib.nullcontext(task_dir) as tmp:
        t0 = time.perf_counter()
        truths, files = write_gmm_task(tmp, n_utts=N_UTTS)
        write_s = time.perf_counter() - t0
        models = ["-h", files["am"], "-v", files["dict"], "-d", files["lm"],
                  "-input", "mfcfile"]
        t0 = time.perf_counter()
        eng = fusion.create_engines(parse_jconf(models), device=DEVICE)[0]
        build_s = time.perf_counter() - t0
        if eng.dnn_scorer is not None or not eng._device_astar_ok():
            raise RuntimeError("the GMM engine does not take the device A*")
        frames = [read_htk_param(p).data for p in files["utts"]]
        lens_np = np.asarray([f.shape[0] for f in frames], np.int32)
        feats = np.zeros((N_UTTS, lens_np.max(), frames[0].shape[1]),
                         np.float32)
        for u, f in enumerate(frames):
            feats[u, :f.shape[0]] = f
        feats = torch.from_numpy(feats).to(DEVICE)
        B, T, D = feats.shape
        dev, tabs, gt = eng.dev_net, eng.device_chains, eng.gmm_tables
        N, K1 = dev.loc_lp.shape[1], dev.loc_lp.shape[0]
        S, M = gt.state_mix.shape
        G = gt.w.shape[1]
        R = S
        phase("cli_models", write_s=write_s, engine_build_s=build_s,
              gaussians=G, senones=S, mixtures=M, dim=D, nodes=N,
              arc_span_k=K1 - 1, words=eng.voca.n_words,
              trellis_m=eng.p1_cfg.n_atoms, utterances=B, frames=T,
              files=sorted(k for k in files if k != "utts"))

        # ---- the GMM scorer: the card against the CPU on a few rows,
        # then its two stages timed over the whole batch
        with torch.no_grad():
            x = feats.reshape(-1, D)
            cpu_t = gmm.build_gmm_tables(eng.hmm, device="cpu")
            want = gmm.senone_scores(cpu_t, x[:256].cpu())
            got = gmm.senone_scores(gt, x[:256]).cpu()
            gmm_err = float((got - want).abs().max())
            if not (torch.isfinite(got).all() and gmm_err <= 1e-3):
                raise RuntimeError(f"GMM scores on the card vs CPU: {gmm_err}")
            g = gmm.gauss_scores(gt, x)
            gauss_ms = time_ms(lambda: gmm.gauss_scores(gt, x), n=10, warm=2)
            mix_ms = time_ms(lambda: gmm.mixture_scores(gt, g), n=10, warm=2)
            del g
        BT = B * T
        g_ops, g_bytes = gauss_cost(BT, D, G)
        m_ops, m_bytes = mixture_cost(BT, S, M)
        scorer = {}
        for name, ms, ops, nbytes in (("gauss", gauss_ms, g_ops, g_bytes),
                                      ("mixture", mix_ms, m_ops, m_bytes)):
            ops_ms = ops / F32_OPS_PER_S * 1e3
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            scorer[name] = dict(
                ms=ms, ops=ops, bytes=nbytes, bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")
        phase("gmm_scorer", rows=BT, dim=D, gaussians=G, senones=S,
              mixtures=M, card_vs_cpu_max_abs_err=gmm_err, **{
                  f"{n}_{k}": v for n, d in scorer.items()
                  for k, v in d.items()}, card=card)

        # ---- the decode staged, after a warm-up, for where the time goes
        eng.decode_features(feats[:2], lens_np[:2])
        torch.cuda.synchronize()
        walls = {}
        with torch.no_grad():
            t0 = time.perf_counter()
            out_ext = eng._outprob(feats)
            torch.cuda.synchronize()
            walls["gmm_wall_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            trellis = eng._pass1(out_ext, lens_np)
            torch.cuda.synchronize()
            walls["pass1_wall_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            staged, spans = traced(eng._results, trellis, lens_np,
                                   out_ext=out_ext)
            p2_s = time.perf_counter() - t0
            del out_ext, trellis
        net = dict(eng.last_pass2)
        walls.update(astar_wall_s=astar_wall(spans),
                     retry_net_wall_s=net["retry_s"],
                     assembly_wall_s=p2_s - astar_wall(spans)
                     - net["retry_s"])
        del eng

        # ---- the command line: all files in one batch, then -lattice
        # -confnet -mbr -n 3 on 4 of them, then -gshmm on 2; the launch
        # counts are set to 0 just before each run and read just after,
        # and both kernels are then checked and timed at the shapes that
        # run gave them, on its engine's tables
        runs = {}
        entries = []
        gram_truths, word_truths, gfiles = write_grammar_task(
            tmp, n_utts=N_SIDE)
        am_only = ["-h", files["am"], "-input", "mfcfile",
                   "-batchsize", str(N_SIDE)]
        dictation = [" ".join(w for w in t if w not in ("<s>", "</s>"))
                     for t in truths]
        # label, argv, inputs, their first sentences, whether pass 1
        # launches the beam-update kernel (the N-gram runs) or takes the
        # unfused step (grammar, isolated words)
        plan = (
            ("cli", models + ["-batchsize", str(N_UTTS)], files["utts"],
             dictation, True),
            ("cli_lattice", models + ["-lattice", "-confnet", "-mbr", "-n",
                                      "3", "-batchsize", str(N_SIDE)],
             files["utts"][:N_SIDE], dictation[:N_SIDE], True),
            ("cli_gshmm", models + ["-gshmm", files["gs"], "-batchsize",
                                    "2"], files["utts"][:2], dictation[:2],
             True),
            ("cli_gram", am_only + ["-gram", gfiles["gram"]],
             gfiles["gram_utts"], [" ".join(t) for t in gram_truths], False),
            ("cli_word", am_only + ["-w", gfiles["wordlist"]],
             gfiles["word_utts"], [" ".join(t) for t in word_truths],
             False))
        for label, argv, inputs, want, fused in plan:
            n = len(inputs)
            results = []
            with recorded_calls(pk, sk, p2d, scan_mod) as calls:
                pk.LAUNCHES = sk.LAUNCHES = we.LAUNCHES = p2r.CHUNKS = 0
                lines, wall, built = run_cli(recognize, argv + inputs,
                                             results)
                launches, scan_launches = pk.LAUNCHES, sk.LAUNCHES
                we_launches = we.LAUNCHES
            chunks = p2r.CHUNKS
            rounds, replayed = (calls["astar"][k]
                                for k in ("rounds", "replayed"))
            t_run = max(read_htk_param(f).data.shape[0] for f in inputs)
            if launches != (t_run if fused else 0):
                raise RuntimeError(f"{label}: {launches} pass1_step launches "
                                   f"for {t_run} frames")
            if scan_launches != replayed + chunks \
                    or (scan_launches > 0) != (label != "cli_word"):
                raise RuntimeError(f"{label}: {scan_launches} scan_win "
                                   f"launches for {replayed} A* rounds "
                                   f"run + {chunks} chunks")
            check_results(results, label, edges={
                "cli_gram": "texts", "cli_word": None}.get(label, "words"))
            got = [ln.split(": ", 1)[1] if ": " in ln else ""
                   for ln in lines if ln.startswith("sentence1:")]
            if len(got) != n:
                raise RuntimeError(f"{label}: {len(got)} sentences for {n} "
                                   "inputs")
            exact = sum(g == w for g, w in zip(got, want))
            runs[label] = dict(
                utterances=n, wall_s=wall, exact_transcripts=f"{exact}/{n}",
                from_pass2=sum(r.from_pass == 2 for r in results),
                astar_rounds=rounds, astar_replayed=replayed,
                rescan_chunks=chunks, kernel_launches=launches,
                scan_win_launches=scan_launches,
                wordgraphs=lines.count("--- begin wordgraph data ---"),
                confnets=lines.count("--- begin confusion network ---"),
                sentences_per_input=sum(ln.startswith("sentence")
                                        for ln in lines) / n)
            measured = path_kernels(
                label, calls, {"pass1_step": launches, "word_end": we_launches,
                               "scan_win": scan_launches}, built[0], card)
            del calls, built
            entries += kernel_entries(label, measured)
    files.update(gram_task=gfiles, gram_truths=gram_truths, truths=truths)
    audio_s = float(lens_np.sum()) / 100.0
    phase("cli", audio_s=audio_s, xrt=audio_s / runs["cli"]["wall_s"],
          staged=walls, runs=runs, card=card)
    if runs["cli"]["exact_transcripts"] != f"{N_UTTS}/{N_UTTS}" \
            or runs["cli"]["from_pass2"] != N_UTTS:
        raise RuntimeError(f"cli: {runs['cli']}")
    lat = runs["cli_lattice"]
    if lat["wordgraphs"] != N_SIDE or lat["confnets"] != N_SIDE:
        raise RuntimeError(f"cli_lattice: {lat}")
    if runs["cli_gshmm"]["exact_transcripts"] != "2/2":
        raise RuntimeError(f"cli_gshmm: {runs['cli_gshmm']}")
    for label in ("cli_gram", "cli_word"):
        if runs[label]["exact_transcripts"] != f"{N_SIDE}/{N_SIDE}":
            raise RuntimeError(f"{label}: {runs[label]}")
    if runs["cli_gram"]["from_pass2"] != N_SIDE:
        raise RuntimeError(f"cli_gram: {runs['cli_gram']}")
    return entries, files


def kernel_entries(path, measured):
    """The kernels line's entries of one path (`path_kernels` output)."""
    sources = {"pass1_step": ("julius_tpu_torch/csrc/pass1_step.cu",
                              "julius_tpu/ops/pass1_kernel.py:49"),
               "scan_win": ("julius_tpu_torch/csrc/scan_win.cu",
                            "julius_tpu/search/scan.py:317"),
               "word_end": ("julius_tpu_torch/csrc/word_end.cu",
                            "julius_tpu/search/pass1.py:267")}
    return [{"name": name, "path": path, "route": "cuda",
             "source": sources[name][0], "replaces": sources[name][1],
             **fields, "library_ms": None}
            for name, fields in measured.items()]


def frame_profile(label, eng, out_ext, lens_np, card):
    """The engine's graphed pass 1 on a batch whose graph exists (so
    replays only) under torch.profiler: the kernels a frame, the card's
    kernel time a frame and the kernels that take most of it (by name),
    and the share of the traced window in which a kernel runs."""
    import os
    from torch.profiler import ProfilerActivity, profile

    T = out_ext.shape[1]
    eng._pass1(out_ext, lens_np)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng._pass1(out_ext, lens_np)
            torch.cuda.synchronize()
        path = os.path.join(tmp, "pass1.json")
        prof.export_chrome_trace(path)
        busy = trace_busy(path)
        with open(path) as fh:
            kernels = [e for e in json.load(fh)["traceEvents"]
                       if e.get("ph") == "X" and e.get("cat") == "kernel"]
    by_name = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    phase("pass1_frame_profile", path=label, frames=T,
          kernels_per_frame=len(kernels) / T,
          kernel_us_per_frame=busy["kernel_busy_ms"] * 1e3 / T,
          window_us_per_frame=busy["window_ms"] * 1e3 / T,
          busy_share=busy["busy_share"],
          top=[dict(name=n[:100], us_per_frame=d / T) for n, d in top],
          card=card)


def astar_profile(label, call, card):
    """One kept device A* call's rounds (`counted_astar`; its graph
    cached, so replays only) under torch.profiler, from loading the
    batch to the last replay: the kernels a round the card ran, the
    card's kernel time a round and the kernels that take most of it, and
    the share of the traced window in which a kernel runs.  The host's
    `prepare` is outside the window."""
    import os
    from torch.profiler import ProfilerActivity, profile
    from julius_tpu_torch.search import pass2_device as p2d

    a, kw = call["args"], call["kw"]
    d, x = p2d._setup(a[0], a[1], a[3], a[4], a[5], a[6], a[7],
                      kw.get("best_in"))
    iwcd2 = kw.get("iwcd2")
    if iwcd2 is not None and iwcd2.n_resolved == 0:
        iwcd2 = None
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with p2d._graphed(a[1], a[2], iwcd2, d, x) as (_, info):
                torch.cuda.synchronize()
        path = os.path.join(tmp, "astar.json")
        prof.export_chrome_trace(path)
        busy = trace_busy(path)
        with open(path) as fh:
            kernels = [e for e in json.load(fh)["traceEvents"]
                       if e.get("ph") == "X" and e.get("cat") == "kernel"]
    n = info["replayed"]
    by_name = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    phase("astar_round_profile", path=label, rounds_run=n,
          captured=info["captured"], kernels_per_round=len(kernels) / n,
          kernel_us_per_round=busy["kernel_busy_ms"] * 1e3 / n,
          window_us_per_round=busy["window_ms"] * 1e3 / n,
          busy_share=busy["busy_share"],
          top=[dict(name=k[:100], us_per_round=v / n) for k, v in top],
          card=card)


def capture_cost(label, call, card, turns=3):
    """Host seconds of capturing the device A*'s round on one kept call's
    inputs (`counted_astar`), through `torch.cuda.graph` (which first
    synchronises the card and empties the allocator's device and
    pinned-host caches) and through capture_begin / capture_end directly
    (search/pass1.py `_capture`), in turns (graph, direct, direct,
    graph, ...), each on fresh fixed tensors after an eager round run to
    its end; then the seconds of the next allocation of the batch's
    outprob cache's size, written and synchronised."""
    from julius_tpu_torch.ops import scan_kernel as sk
    from julius_tpu_torch.search import pass2_device as p2d

    a, kw = call["args"], call["kw"]
    d, x = p2d._setup(a[0], a[1], a[3], a[4], a[5], a[6], a[7],
                      kw.get("best_in"))
    iwcd2 = kw.get("iwcd2")
    if iwcd2 is not None and iwcd2.n_resolved == 0:
        iwcd2 = None
    side = torch.cuda.Stream()
    n0, runs = sk.CAPTURED, []
    for i in range(2 * turns):
        way = ("graph", "direct")[(i + i // 2) % 2]
        pool = torch.cuda.graph_pool_handle()     # the last one's is gone
        r = p2d._Rounds(a[1], a[2], iwcd2, d, x)
        r.load(x)
        graph = torch.cuda.CUDAGraph()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            r.step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if way == "graph":
                with torch.cuda.graph(graph, pool=pool, stream=side,
                                      capture_error_mode="thread_local"):
                    r.step()
            else:
                graph.capture_begin(pool, capture_error_mode="thread_local")
                try:
                    r.step()
                finally:
                    graph.capture_end()
            capture_s = time.perf_counter() - t0
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = torch.empty_like(x.out_ext).fill_(0.0)
        torch.cuda.synchronize()
        runs.append(dict(way=way, capture_s=capture_s,
                         next_alloc_s=time.perf_counter() - t0))
        del r, graph, y
    sk.CAPTURED = n0
    phase("capture_cost", path=label, runs=runs, card=card)


def launch_guard(dev, card, n=100_000):
    """The host cost of the kernels' device guard (cuda_build.on_device)
    a call, on the card that is current (nothing to enter, as on one
    card) and through torch.cuda.device itself (what a call on another
    card enters); pass 1's eager loop on the kernel path makes one call
    a frame."""
    from julius_tpu_torch.ops import cuda_build

    costs = {}
    for name, ctx in (("guard_us", cuda_build.on_device),
                      ("device_context_us", torch.cuda.device)):
        t0 = time.perf_counter()
        for _ in range(n):
            with ctx(dev):
                pass
        costs[name] = (time.perf_counter() - t0) * 1e6 / n
    phase("launch_guard", calls=n, **costs,
          guard_us_per_frame_kernel_path=costs["guard_us"], card=card)
    return costs


def timed_pass1(eng, out_ext, lens_np):
    """Pass 1 alone on cached outprobs -> wall seconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng._pass1(out_ext, lens_np)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def grammar_phase(eng, protos, card):
    """The slice's path: a DFA grammar over the flagship's vocabulary and
    model, compiled by the port's grammar.compile_grammar, decodes 16
    sentences the grammar accepts through Engine.decode_features with the
    default pass 2 (the host re-scan with the DFA, whose word scans
    launch scan_win), then 4 of them with the frozen DFA search.  Returns
    the kernels' entries for the JSON line."""
    from julius_tpu_torch import grammar
    from julius_tpu_torch.engine import Engine
    from julius_tpu_torch.ops import pass1_kernel as pk
    from julius_tpu_torch.ops import scan_kernel as sk
    from julius_tpu_torch.ops import word_end_kernel as we
    from julius_tpu_torch.search import pass2_device as p2d
    from julius_tpu_torch.search import pass2_rescan as p2r
    from julius_tpu_torch.search import scan as scan_mod
    from julius_tpu_torch.tools import synth

    t0 = time.perf_counter()
    gtext, vtext = synth.make_grammar(eng.voca, N_CATS)
    dfa, dfa_fwd, voca, word_cat, cats = grammar.compile_grammar(gtext,
                                                                 vtext)
    wc = np.asarray(word_cat, np.int32)
    geng = Engine(eng.hmm, voca, dnn=eng.dnn_params, frontend=eng.fe_cfg,
                  search=eng.search_cfg, dfa=dfa, word_cat=wc, device=DEVICE)
    build_s = time.perf_counter() - t0
    if not (geng.lmtype == "grammar" and geng._rescan_ok()
            and not geng._device_astar_ok()):
        raise RuntimeError("the grammar engine does not take the re-scan")
    seqs = synth.grammar_sentences(dfa_fwd, wc, N_UTTS, seed=7)
    wins, lens = synth.make_word_utts(eng.hmm, voca, protos, seqs, 120, 11,
                                      seed=7)
    feats, lens_np = pad_windows(wins, lens)
    T = feats.shape[1]
    truths = [[voca.outputs[w] for w in q] for q in seqs]
    phase("grammar_engine", seconds=build_s, categories=len(cats),
          dfa_states=dfa.n_states, forward_dfa_states=dfa_fwd.n_states,
          grammar_rules=gtext.count("\n"), words=voca.n_words,
          nodes=int(geng.dev_net.score_idx.shape[0]),
          trellis_m=geng.p1_cfg.n_atoms, utterances=N_UTTS, frames=T,
          words_per_sentence=[len(q) for q in seqs])

    geng.decode_features(feats[:2], lens_np[:2])        # warm-up
    torch.cuda.synchronize()
    with recorded_calls(pk, sk, p2d, scan_mod) as calls:
        pk.LAUNCHES = sk.LAUNCHES = we.LAUNCHES = p2r.CHUNKS = 0
        t0 = time.perf_counter()
        res = geng.decode_features(feats, lens_np)
        wall = time.perf_counter() - t0
        launches, scan_launches, chunks = pk.LAUNCHES, sk.LAUNCHES, p2r.CHUNKS
        we_launches = we.LAUNCHES
    if launches != 0 or scan_launches != chunks or scan_launches == 0:
        raise RuntimeError(f"grammar: {launches} pass1_step and "
                           f"{scan_launches} scan_win launches for {chunks} "
                           "re-scan chunks")
    exact = sum(r.texts == t for r, t in zip(res, truths))
    accepted = sum(r.valid and dfa.accepts_forward(
        [int(wc[w]) for w in r.word_ids]) for r in res)
    with torch.no_grad():
        out_ext = geng._outprob(feats)
        p1_s = timed_pass1(geng, out_ext, lens_np)
        del out_ext
    side = slice(0, N_SIDE)
    base = geng.search_cfg
    geng.search_cfg = dataclasses.replace(base, pass2_rescan=False)
    try:
        t0 = time.perf_counter()
        res_f = geng.decode_features(feats[side], lens_np[side])
        frozen_s = time.perf_counter() - t0
    finally:
        geng.search_cfg = base
    measured = path_kernels("grammar", calls, {"pass1_step": launches,
                                               "word_end": we_launches,
                                               "scan_win": scan_launches},
                            geng, card)
    exact_f = sum(r.texts == t for r, t in zip(res_f, truths[side]))
    phase("grammar", utterances=N_UTTS, frames=T,
          audio_s=float(lens_np.sum()) / 100.0, e2e_wall_s=wall,
          exact_transcripts=f"{exact}/{N_UTTS}",
          from_pass2=sum(r.from_pass == 2 for r in res),
          dfa_accepted=f"{accepted}/{N_UTTS}", pass1_wall_s=p1_s,
          pass1_ms_per_frame=p1_s * 1e3 / T,
          pass1_step_launches=launches,
          pass1_step_note="0: the grammar path runs pass 1's unfused "
                          "step, as the reference runs XLA there",
          scan_win_launches=scan_launches, rescan_chunks=chunks,
          frozen=dict(utterances=N_SIDE, wall_s=frozen_s,
                      exact_transcripts=f"{exact_f}/{N_SIDE}",
                      from_pass2=sum(r.from_pass == 2 for r in res_f),
                      dfa_accepted=sum(dfa.accepts_forward(
                          [int(wc[w]) for w in r.word_ids])
                          for r in res_f if r.valid)),
          card=card)
    if exact != N_UTTS or accepted != N_UTTS:
        raise RuntimeError(f"grammar: {exact}/{N_UTTS} exact, "
                           f"{accepted}/{N_UTTS} accepted by the DFA")
    return kernel_entries("grammar", measured)


def isolated_phase(eng, protos, card):
    """Isolated-word recognition over the flagship's 5000 words: 16
    one-word utterances through Engine.decode_features, pass 1 only."""
    from julius_tpu_torch.engine import Engine
    from julius_tpu_torch.ops import pass1_kernel as pk
    from julius_tpu_torch.ops import scan_kernel as sk
    from julius_tpu_torch.ops import word_end_kernel as we
    from julius_tpu_torch.tools import synth

    ieng = Engine(eng.hmm, eng.voca, dnn=eng.dnn_params, frontend=eng.fe_cfg,
                  search=eng.search_cfg, lmtype="word", device=DEVICE)
    rng = np.random.default_rng(11)
    words = [[int(w)] for w in rng.integers(2, eng.voca.n_words, N_UTTS)]
    wins, lens = synth.make_word_utts(eng.hmm, eng.voca, protos, words, 120,
                                      11, seed=11)
    feats, lens_np = pad_windows(wins, lens)
    T = feats.shape[1]
    ieng.decode_features(feats[:2], lens_np[:2])        # warm-up
    torch.cuda.synchronize()
    pk.LAUNCHES = sk.LAUNCHES = we.LAUNCHES = 0
    t0 = time.perf_counter()
    res = ieng.decode_features(feats, lens_np)
    wall = time.perf_counter() - t0
    launches, scan_launches = pk.LAUNCHES, sk.LAUNCHES
    we_launches = we.LAUNCHES
    if launches or scan_launches or we_launches != T:
        raise RuntimeError(f"isolated: {launches} pass1_step, "
                           f"{scan_launches} scan_win and {we_launches} "
                           f"word_end launches for {T} frames")
    exact = sum(r.word_ids == w for r, w in zip(res, words))
    with torch.no_grad():
        out_ext = ieng._outprob(feats)
        p1_s = timed_pass1(ieng, out_ext, lens_np)
        graph = graph_vs_eager("isolated", ieng.dev_net, ieng.ngram_dev,
                               ieng.p1_cfg, out_ext, lens_np, card=card)
        del out_ext
    phase("isolated", utterances=N_UTTS, frames=T, words=eng.voca.n_words,
          e2e_wall_s=wall, exact_transcripts=f"{exact}/{N_UTTS}",
          from_pass1=sum(r.from_pass == 1 for r in res),
          pass1_wall_s=p1_s, pass1_ms_per_frame=p1_s * 1e3 / T,
          pass1_eager_ms_per_frame=graph["eager_ms_per_frame"],
          pass1_step_launches=launches, scan_win_launches=scan_launches,
          word_end_launches=we_launches, card=card)
    if exact < N_UTTS - 1 or any(r.from_pass != 1 for r in res):
        raise RuntimeError(f"isolated: {exact}/{N_UTTS} exact")


def unfused_run(label, ueng, fused_eng, feats, lens_np, truths, card):
    """One N-gram configuration that takes pass 1's unfused step: a
    decode through Engine.decode_features (the launch counts read around
    it, scan_win held and timed at its shapes), then pass 1 alone timed
    beside the fused path's on the same outprobs.  -> (phase fields,
    kernel entries)."""
    from julius_tpu_torch.ops import pass1_kernel as pk
    from julius_tpu_torch.ops import scan_kernel as sk
    from julius_tpu_torch.ops import word_end_kernel as we
    from julius_tpu_torch.search import pass1 as p1
    from julius_tpu_torch.search import pass2_device as p2d
    from julius_tpu_torch.search import pass2_rescan as p2r
    from julius_tpu_torch.search import scan as scan_mod

    if p1.fused_ok(ueng.dev_net, ueng.p1_cfg):
        raise RuntimeError(f"{label}: the configuration takes the kernel")
    B, T = feats.shape[0], feats.shape[1]
    ueng.decode_features(feats[:2], lens_np[:2])        # warm-up
    torch.cuda.synchronize()
    with recorded_calls(pk, sk, p2d, scan_mod) as calls:
        pk.LAUNCHES = sk.LAUNCHES = we.LAUNCHES = p2r.CHUNKS = 0
        t0 = time.perf_counter()
        res = ueng.decode_features(feats, lens_np)
        wall = time.perf_counter() - t0
        launches, scan_launches = pk.LAUNCHES, sk.LAUNCHES
        we_launches = we.LAUNCHES
    chunks = p2r.CHUNKS
    rounds, replayed = (calls["astar"][k] for k in ("rounds", "replayed"))
    if launches or scan_launches != replayed + chunks or not scan_launches:
        raise RuntimeError(f"{label}: {launches} pass1_step and "
                           f"{scan_launches} scan_win launches for "
                           f"{replayed} A* rounds run + {chunks} chunks")
    check_results(res, label)
    exact = exact_count(res, truths)
    with torch.no_grad():
        out_ext = ueng._outprob(feats)
        unfused_s = timed_pass1(ueng, out_ext, lens_np)
        fused_s = timed_pass1(fused_eng, out_ext, lens_np)
    measured = path_kernels(label, calls, {"pass1_step": launches,
                                           "word_end": we_launches,
                                           "scan_win": scan_launches},
                            ueng, card)
    fields = dict(utterances=B, frames=T, e2e_wall_s=wall,
                  exact_transcripts=f"{exact}/{B}",
                  from_pass2=sum(r.from_pass == 2 for r in res),
                  retried=ueng.last_pass2["retried"],
                  unfused_pass1_ms_per_frame=unfused_s * 1e3 / T,
                  fused_pass1_ms_per_frame=fused_s * 1e3 / T,
                  pass1_step_launches=launches,
                  scan_win_launches=scan_launches, astar_rounds=rounds,
                  astar_replayed=replayed, rescan_chunks=chunks)
    if exact < B - 1:
        raise RuntimeError(f"{label}: {fields}")
    return fields, kernel_entries(label, measured)


def unfused_ngram_phase(eng, feats, lens_np, truths, card):
    """The flagship with factoring 2 and with a score envelope
    (beam_width 400), on 4 of its utterances.  Returns the kernels'
    entries for the JSON line."""
    from julius_tpu_torch.engine import Engine

    runs, entries = {}, []
    side = slice(0, N_SIDE)
    for label, kw in (("factoring2", dict(factoring=2)),
                      ("envelope", dict(beam_width=400))):
        ueng = Engine(eng.hmm, eng.voca, eng.lm, dnn=eng.dnn_params,
                      frontend=eng.fe_cfg,
                      search=dataclasses.replace(eng.search_cfg, **kw),
                      device=DEVICE)
        runs[label], e = unfused_run(label, ueng, eng, feats[side],
                                     lens_np[side], truths[side], card)
        entries += e
        del ueng
    phase("unfused_ngram", runs=runs, card=card)
    return entries


def gather_phase(card):
    """The incoming-arc gather (a topology with backward in-word arcs):
    no model in the repo has it at full width, so it is held card
    against CPU at the tests' size (24 phones, 60 words, random outprob
    rows), pass 1 and the frozen pass 2."""
    from julius_tpu_torch.config import SearchConfig
    from julius_tpu_torch.engine import Engine
    from julius_tpu_torch.ops import pass1_kernel as pk
    from julius_tpu_torch.tools import synth

    hmm = synth.make_hmmset(n_phones=24, dim=8, seed=4)
    hmm.phone_trans[:, 3, 2] = np.log(0.1)
    voca = synth.make_vocabulary(hmm, n_words=60, seed=5)
    lm = synth.make_ngram(voca, seed=6)
    search = SearchConfig(trellis_topm=16, lm_weight=4.0)
    card_eng, cpu_eng = (Engine(hmm, voca, lm, search=search, device=d)
                         for d in (DEVICE, "cpu"))
    if card_eng.dev_net.local_k >= 0 or card_eng._rescan_ok():
        raise RuntimeError("gather: the network is shift-structured")
    rows = np.random.default_rng(7).normal(
        -8.0, 3.0, (3, 70, hmm.n_states)).astype(np.float32)
    lens = np.asarray([70, 52, 31], np.int32)
    pk.LAUNCHES = 0
    rows_card = torch.from_numpy(rows).to(DEVICE)
    tr_card = card_eng._pass1(rows_card, lens)
    graph_vs_eager("gather", card_eng.dev_net, card_eng.ngram_dev,
                   card_eng.p1_cfg, rows_card, lens, got=tr_card, card=card)
    tr_cpu = cpu_eng._pass1(torch.from_numpy(rows), lens)
    valid = tr_cpu.word >= 0
    err = float(torch.where(valid, (tr_card.score.cpu() - tr_cpu.score).abs(),
                            0.0).max())
    same = all(torch.equal(torch.where(valid, getattr(tr_card, f).cpu(), 0),
                           torch.where(valid, getattr(tr_cpu, f), 0))
               for f in ("word", "prev", "begin", "ectx"))
    got = card_eng.decode_outprob(rows, lens)
    want = cpu_eng.decode_outprob(rows, lens)
    same_words = [r.word_ids for r in got] == [r.word_ids for r in want]
    phase("gather", note="held card against CPU at the tests' size: no "
          "model in the repo has this topology at full width",
          nodes=card_eng.net.n_nodes, words=voca.n_words,
          in_arcs=int(card_eng.dev_net.in_src.shape[1]),
          trellis_max_abs_err=err, trellis_ints_equal=same,
          decode_words_equal=same_words,
          from_pass=[r.from_pass for r in got],
          pass1_step_launches=pk.LAUNCHES, card=card)
    if err > 1e-5 or not same or not same_words or pk.LAUNCHES:
        raise RuntimeError("gather: the card differs from the CPU")


ALIGN = dict(align_word=True, align_phoneme=True, align_state=True)
N_STREAM, STREAM_S = 4, 10.0  # the stream phase's waveforms
BLOCK = 16                    # frames a stream block
CHUNK_SAMPLES = 1600          # 100 ms of 16 kHz audio a feed


@contextlib.contextmanager
def counted_astar(p2d):
    """Keep every device A* call in the block (LAST_STATS keeps the last
    call's only).  Yields {"rounds": n, "replayed": n, "calls": [...]}:
    the rounds searched, the rounds the card ran (the gated rounds past
    the end included, one scan_win launch each), and each call that
    searched (its arguments, its outprob cache copied, its N-best lists
    as `nbest_tuples`, and LAST_STATS with the call's span totals under
    "spans", the port's tracer on around it) for `astar_vs_eager`."""
    total = {"rounds": 0, "replayed": 0, "calls": []}
    real = p2d.run_batch

    def run_batch(*a, **kw):
        p2d.LAST_STATS.clear()
        out, spans = traced(real, *a, **kw)
        stats = dict(p2d.LAST_STATS)
        if stats:
            stats["spans"] = spans
            total["rounds"] += stats["rounds"]
            total["replayed"] += stats["replayed"]
            a = list(a)
            a[5] = a[5].clone()                 # the outprob cache
            # the lists as returned (the retry net replaces some after)
            total["calls"].append(dict(args=a, kw=kw, got=nbest_tuples(out),
                                       stats=stats))
        return out

    p2d.run_batch = run_batch
    try:
        yield total
    finally:
        p2d.run_batch = real


#: every astar_graph line of the run, for the summary before the kernels
ASTAR_LINES = []
#: the spans of the device A*'s wall: set-up (with `prepare`), the
#: rounds, the read-back
ASTAR_SPANS = ("astar.setup", "astar.rounds", "astar.collect")


def traced(fn, *a, **kw):
    """fn(*a, **kw) with the port's tracer on: (its result, the spans'
    `trace.Totals` by name).  Not nested: an inner call would drain the
    outer one's spans."""
    from julius_tpu_torch.utils import trace
    if trace.enabled():
        raise RuntimeError("traced calls do not nest")
    trace.drain()
    trace.enable(True)
    try:
        out = fn(*a, **kw)
    finally:
        trace.enable(False)
    return out, trace.totals(trace.drain())


def astar_wall(spans):
    """The host seconds of the device A*'s calls among `spans`."""
    return sum(spans[k].total_s for k in ASTAR_SPANS if k in spans)


def nbest_tuples(lists):
    return [[dataclasses.astuple(r) for r in x] for x in lists]


def astar_vs_eager(label, astar, card, record=None):
    """Each device A* call of one path (`counted_astar`), graphed as the
    path ran it, run again as its eager oracle (eager=True: the same
    round once a round from Python) on the same inputs: the N-best lists
    must be equal bit for bit, with equal rounds and pops.  The oracle
    runs inside `record` (a context) where given; its launches are taken
    back out of LAUNCHES.  Prints one astar_graph line: both loop walls
    (the `astar.rounds` spans: the cache lookup to the last read of the
    stop flag), the rounds, the rounds the card ran, the host waits,
    captures and their seconds, G, and the A* wall split into set-up
    (`astar.setup`, with prepare), loop and read-back (`astar.collect`);
    returns its fields."""
    from julius_tpu_torch.ops import scan_kernel as sk
    from julius_tpu_torch.search import pass2_device as p2d

    n0 = sk.LAUNCHES
    per = []
    for c in astar["calls"]:
        torch.cuda.synchronize()
        with record() if record else contextlib.nullcontext():
            eager, e_spans = traced(p2d.run_batch, *c["args"], **c["kw"],
                                    eager=True)
        e, g = dict(p2d.LAST_STATS), c["stats"]
        spans = g["spans"]
        per.append(dict(
            batch=g["B"], frames=g["T"], atoms=g["NA"], rounds=g["rounds"],
            replayed=g["replayed"], waits=g["waits"], captured=g["captured"],
            capture_s=g["capture_s"],
            graphed_loop_s=spans["astar.rounds"].total_s,
            eager_loop_s=e_spans["astar.rounds"].total_s,
            prepare_s=spans["astar.setup"].total_s,
            readback_s=spans["astar.collect"].total_s,
            bit_equal=(nbest_tuples(eager) == c["got"]
                       and e["rounds"] == g["rounds"]
                       and e["n_pops"] == g["n_pops"] and g["graphed"]
                       and not e["graphed"])))
    sk.LAUNCHES = n0

    def total(k):
        return sum(x[k] for x in per)

    fields = dict(
        path=label, calls=len(per), rounds=total("rounds"),
        replayed=total("replayed"), waits=total("waits"),
        captures=total("captured"), capture_s=total("capture_s"),
        stop_every=p2d.STOP_EVERY, graphed_loop_s=total("graphed_loop_s"),
        eager_loop_s=total("eager_loop_s"),
        eager_over_graphed=(total("eager_loop_s")
                            / max(total("graphed_loop_s"), 1e-9)),
        prepare_s=total("prepare_s"), readback_s=total("readback_s"),
        bit_equal=all(x["bit_equal"] for x in per), per_call=per)
    phase("astar_graph", **fields, card=card)
    ASTAR_LINES.append(fields)
    if not per or not fields["bit_equal"]:
        raise RuntimeError(f"{label}: graphed A* differs from its eager "
                           f"oracle: {fields}")
    return fields


def astar_split(fields):
    """A staged decode's device A* wall split (`astar_vs_eager` fields):
    the host's prepare, the graphed loop and the readback, and the eager
    oracle's loop beside it."""
    return dict(astar_prepare_s=fields["prepare_s"],
                astar_graphed_loop_s=fields["graphed_loop_s"],
                astar_readback_s=fields["readback_s"],
                astar_eager_loop_s=fields["eager_loop_s"],
                astar_graphed_rounds_run=fields["replayed"],
                astar_host_waits=fields["waits"])


#: every suffix_check line of the run
SUFFIX_LINES = []


def suffix_path(label, astar, card):
    """The A*'s suffix DP kernel (csrc/suffix.cu) alone on each device A*
    call of one path (`counted_astar`): one launch over the call's
    pass-1 trellis on the card (its lattices uploaded where the call had
    none, as `prepare` uploads them) and its frames' best outprob, each
    utterance's estimate held bit for bit to the plain version
    (`suffix_plain` on the same trellis on the CPU).  The first call
    timed: the kernel (CUDA events around the wrapper's call, median of
    20) against one plain pass over its utterances (host clock).  Prints
    one suffix_check line; returns its fields."""
    from julius_tpu_torch.ops import suffix_kernel as sx
    from julius_tpu_torch.search import pass1 as p1
    from julius_tpu_torch.search import pass2_device as p2d
    from julius_tpu_torch.utils.cuda_timing import time_ms

    per = []
    for i, c in enumerate(astar["calls"]):
        lats, out_ext, cfg = c["args"][0], c["args"][5], c["args"][7]
        lats = [lat if lat is not None and lat.T else None for lat in lats]
        fmax = out_ext.to(torch.float32).amax(dim=2)
        tr = c["kw"].get("trellis")
        T = out_ext.shape[1]
        tr_cpu = None if tr is None else p1.Trellis(
            *[a.cpu() for a in tr[:5]], None)

        def run():
            return p2d._suffix_launch(lats, T, tr, fmax, cfg)
        got = run().cpu().numpy()
        frames = [lat.T for lat in lats if lat is not None]
        t0 = time.perf_counter()
        want = p2d._suffix_launch(lats, T, tr_cpu, fmax.cpu(), cfg).numpy()
        plain_ms = (time.perf_counter() - t0) * 1e3
        equal = np.array_equal(got, want)
        M = next(lat.M for lat in lats if lat is not None)
        x = dict(utterances=len(frames), frames=sum(frames),
                 longest=max(frames), M=M, plan=list(sx.plan(M)),
                 uploaded=tr is None, bit_equal=equal)
        if i == 0:
            ms = time_ms(run, n=20, warm=3)
            x.update(kernel_ms=ms, plain_ms=plain_ms,
                     us_per_frame=ms * 1e3 / max(frames),
                     plain_us_per_frame=plain_ms * 1e3 / sum(frames),
                     plain_over_kernel=plain_ms / ms)
        per.append(x)
    fields = dict(path=label, calls=len(per),
                  utterances=sum(x["utterances"] for x in per),
                  bit_equal=all(x["bit_equal"] for x in per),
                  **({k: per[0][k] for k in (
                      "M", "plan", "kernel_ms", "plain_ms", "us_per_frame",
                      "plain_us_per_frame", "plain_over_kernel",
                      "longest", "uploaded")} if per else {}),
                  per_call=per)
    phase("suffix_check", **fields, card=card)
    SUFFIX_LINES.append(fields)
    if not per or not fields["bit_equal"]:
        raise RuntimeError(f"{label}: the suffix kernel differs from "
                           f"its plain version: {fields}")
    return fields


#: STOP_EVERY values of the sweep, run up and back down
SWEEP_G = (1, 2, 4, 8, 16)


def stop_every_sweep(label, call, card):
    """One kept device A* call (`counted_astar`) again, graphed from its
    cached graph, at each STOP_EVERY of SWEEP_G and back: the loop wall,
    the host waits and the gated rounds past the end at each G, for the
    choice of STOP_EVERY.  Each result must equal the call's."""
    from julius_tpu_torch.ops import scan_kernel as sk
    from julius_tpu_torch.search import pass2_device as p2d

    chosen, n0 = p2d.STOP_EVERY, sk.LAUNCHES
    runs = []
    try:
        for G in SWEEP_G + SWEEP_G[::-1]:
            p2d.STOP_EVERY = G
            torch.cuda.synchronize()
            got, spans = traced(p2d.run_batch, *call["args"], **call["kw"])
            st = dict(p2d.LAST_STATS)
            runs.append(dict(
                stop_every=G, loop_s=spans["astar.rounds"].total_s,
                waits=st["waits"],
                past_end=st["replayed"] - st["rounds"],
                captured=st["captured"],
                equal=nbest_tuples(got) == call["got"]))
    finally:
        p2d.STOP_EVERY = chosen
        sk.LAUNCHES = n0
    phase("astar_stop_every", path=label, rounds=call["stats"]["rounds"],
          chosen=chosen, runs=runs, card=card)
    if not all(r["equal"] for r in runs):
        raise RuntimeError(f"{label}: the A* at another STOP_EVERY differs")


def align_phase(eng, protos, card):
    """-walign -palign -salign through Engine.decode_features on 16
    generative flagship utterances (the slice's decode, then a forced
    alignment of each result on the card); the alignment Viterbi held
    card against CPU on the same outprob rows.  Returns the kernels'
    entries for the JSON line."""
    from julius_tpu_torch.ops import pass1_kernel as pk
    from julius_tpu_torch.ops import scan_kernel as sk
    from julius_tpu_torch.ops import word_end_kernel as we
    from julius_tpu_torch.search import align as al
    from julius_tpu_torch.search import pass2_device as p2d
    from julius_tpu_torch.search import pass2_rescan as p2r
    from julius_tpu_torch.search import scan as scan_mod
    from julius_tpu_torch.tools.synth import make_flagship_utts

    truths, wins, lens, counts = make_flagship_utts(
        eng.hmm, eng.voca, eng.lm, protos, N_UTTS, 120, 11, min_words=6,
        max_words=12, seed=3, word_counts=True)
    feats, lens_np = pad_windows(wins, lens)
    T = feats.shape[1]
    base = eng.search_cfg
    eng.search_cfg = dataclasses.replace(base, **ALIGN)
    walls = []

    def timed_align(*a, _real=eng.align, **kw):
        t0 = time.perf_counter()
        out = _real(*a, **kw)       # ends with its host copy
        walls.append(time.perf_counter() - t0)
        return out

    eng.align = timed_align
    try:
        eng.decode_features(feats[:2], lens_np[:2])        # warm-up
        torch.cuda.synchronize()
        walls.clear()
        with recorded_calls(pk, sk, p2d, scan_mod) as calls:
            pk.LAUNCHES = sk.LAUNCHES = we.LAUNCHES = p2r.CHUNKS = 0
            t0 = time.perf_counter()
            res = eng.decode_features(feats, lens_np)
            wall = time.perf_counter() - t0
            launches, scan_launches = pk.LAUNCHES, sk.LAUNCHES
            we_launches = we.LAUNCHES
        chunks = p2r.CHUNKS
        rounds, replayed = (calls["astar"][k] for k in ("rounds", "replayed"))
    finally:
        eng.search_cfg = base
        del eng.align
    if launches != T or scan_launches != replayed + chunks \
            or not scan_launches:
        raise RuntimeError(f"align: {launches} pass1_step launches for {T} "
                           f"frames, {scan_launches} scan_win for {replayed} "
                           f"A* rounds run + {chunks} chunks")
    check_results(res, "align")
    exact = exact_count(res, truths)
    worst, n_checked = 0, 0
    for r, truth, cnt, n in zip(res, truths, counts, lens_np):
        a = r.alignment
        if a is None or not (a.phones and a.states):
            raise RuntimeError(f"align: a result without an alignment {r}")
        if [w["word"] for w in a.words] != r.words:
            raise RuntimeError(f"align: words {a.words} for {r.words}")
        spans = [(w["begin"], w["end"]) for w in a.words]
        if spans[0][0] != 0 or spans[-1][1] != n - 1 or any(
                b[0] != e[1] + 1 for e, b in zip(spans, spans[1:])):
            raise RuntimeError(f"align: segments {spans} do not tile "
                               f"0..{n - 1}")
        if r.words == truth:
            ends = np.cumsum(cnt) - 1
            worst = max(worst, max(abs(e[1] - int(g)) for e, g in
                                   zip(spans[:-1], ends[:-1])))
            n_checked += 1
    # the alignment Viterbi on the card against the CPU on the same rows
    vit_err, vit_same = 0.0, True
    with torch.no_grad():
        for b in range(N_SIDE):
            chain = al.build_chain(eng.hmm, eng.voca, res[b].word_ids,
                                   pseudo=eng.net.pseudo)
            n = int(lens_np[b])
            out = eng._outprob(feats[b:b + 1])[0, :n]
            gs, gbp, gbest = al.viterbi_chain(
                *al.chain_tensors(chain, DEVICE), out, n,
                graphs=eng.align_graphs)
            ws, wbp, wbest = al.viterbi_chain(
                *al.chain_tensors(chain, "cpu"), out.cpu(), n)
            vit_same &= bool(torch.equal(gbp.cpu(), wbp)
                             and int(gbest) == int(wbest))
            vit_err = max(vit_err, abs(float(gs) - float(ws)))
    measured = path_kernels("align", calls, {"pass1_step": launches,
                                             "word_end": we_launches,
                                             "scan_win": scan_launches},
                            eng, card)
    phase("align", utterances=N_UTTS, frames=T,
          align_wall_split_ms_per_utterance=ALIGN_LINES[-1][
              "wall_split_ms_per_utterance"],
          audio_s=float(lens_np.sum()) / 100.0, e2e_wall_s=wall,
          align_wall_s=sum(walls),
          align_ms_per_utterance=[w * 1e3 for w in walls],
          align_ms_per_utterance_mean=sum(walls) * 1e3 / max(1, len(walls)),
          exact_transcripts=f"{exact}/{N_UTTS}",
          aligned=sum(r.alignment is not None for r in res),
          boundaries_checked=n_checked, worst_boundary_frames=worst,
          viterbi_card_vs_cpu_backpointers_equal=vit_same,
          viterbi_card_vs_cpu_score_err=vit_err,
          pass1_step_launches=launches, scan_win_launches=scan_launches,
          astar_rounds=rounds, astar_replayed=replayed, rescan_chunks=chunks,
          card=card)
    if exact < N_UTTS - 1 or worst > 3 or not vit_same or vit_err > 1e-3:
        raise RuntimeError(f"align: {exact}/{N_UTTS} exact, worst boundary "
                           f"{worst} frames, Viterbi card vs CPU "
                           f"{vit_same} / {vit_err}")
    return kernel_entries("align", measured)


def stream_phase(eng, card):
    """4 seeded 10 s waveforms, each fed to StreamSession (no VAD,
    16-frame blocks) in 100 ms chunks on the card and decoded by
    recognize_batch on the card: the same words, scores within 0.5; the
    ms a block and the segment-end delay; scan_win held and timed at the
    shapes the streams gave it.  Returns the kernels' entries."""
    from julius_tpu_torch.frontend import mfcc as fe
    from julius_tpu_torch.frontend.stream import StreamingFrontend
    from julius_tpu_torch.ops import pass1_kernel as pk
    from julius_tpu_torch.ops import scan_kernel as sk
    from julius_tpu_torch.ops import word_end_kernel as we
    from julius_tpu_torch.search import pass1 as p1
    from julius_tpu_torch.search import pass2_device as p2d
    from julius_tpu_torch.search import pass2_rescan as p2r
    from julius_tpu_torch.search import scan as scan_mod
    from julius_tpu_torch.streaming import StreamSession

    L = int(STREAM_S * 16000)
    rng = np.random.default_rng(21)
    waves = (2000.0 * rng.standard_normal((N_STREAM, L))).astype(np.float32)
    lens = np.full(N_STREAM, L, np.int32)
    t0 = time.perf_counter()
    batch = eng.recognize_batch(waves, lens)
    batch_s = time.perf_counter() - t0
    with torch.no_grad():
        _, nfr, batch_out = eng._decode_device(
            torch.from_numpy(waves).to(DEVICE), torch.from_numpy(lens)
            .to(DEVICE))
    # the streaming front end against the batch front end
    sfe = StreamingFrontend(eng.fe_cfg, device=DEVICE)
    got = [sfe.process(waves[0, o:o + CHUNK_SAMPLES])
           for o in range(0, L, CHUNK_SAMPLES)] + [sfe.finalize()]
    got = np.concatenate(got)
    with torch.no_grad():
        want = fe.extract_features(torch.from_numpy(waves[:1]).to(DEVICE),
                                   torch.from_numpy(lens[:1]).to(DEVICE),
                                   eng.fe_tables)[0][0].cpu().numpy()
    fe_err = float(np.abs(got - want[:got.shape[0]]).max()) \
        if got.shape == want.shape else float("inf")

    blocks, delays, caches, walls = [], [], [], []
    marks = {}
    real_finalize, real_p2 = p1.pass1_stream_finalize, eng._pass2_result

    def finalize(*a, **kw):
        marks["t0"] = time.perf_counter()
        return real_finalize(*a, **kw)

    def pass2(tr, T, out_ext=None):
        caches.append(None if out_ext is None else out_ext[0].clone())
        return real_p2(tr, T, out_ext=out_ext)

    def one_stream(wave, timed):
        sess = StreamSession(eng, use_vad=False, block_frames=BLOCK)
        real_block = sess._run_block

        def run_block(final):
            n0, t0 = sess._nframes, time.perf_counter()
            real_block(final)
            if timed:
                blocks.append((sess._nframes - n0,
                               (time.perf_counter() - t0) * 1e3))

        sess._run_block = run_block
        out = []
        t0 = time.perf_counter()
        for o in range(0, len(wave), CHUNK_SAMPLES):
            out.extend(sess.feed(wave[o:o + CHUNK_SAMPLES]))
        out.extend(sess.close())
        if timed:
            t1 = time.perf_counter()
            delays.append((t1 - marks["t0"]) * 1e3)
            walls.append(t1 - t0)
        return out

    p1.pass1_stream_finalize = finalize
    eng._pass2_result = pass2
    try:
        one_stream(waves[0, :32000], timed=False)           # warm-up
        caches.clear()
        torch.cuda.synchronize()
        res = []
        with recorded_calls(pk, sk, p2d, scan_mod) as calls:
            pk.LAUNCHES = sk.LAUNCHES = we.LAUNCHES = p2r.CHUNKS = 0
            for u in range(N_STREAM):
                res.append(one_stream(waves[u], timed=True))
            launches, scan_launches = pk.LAUNCHES, sk.LAUNCHES
            we_launches = we.LAUNCHES
        chunks = p2r.CHUNKS
        rounds, replayed = (calls["astar"][k] for k in ("rounds", "replayed"))
    finally:
        p1.pass1_stream_finalize = real_finalize
        del eng._pass2_result
    if any(len(r) != 1 for r in res):
        raise RuntimeError(f"stream: {[len(r) for r in res]} results")
    res = [r[0] for r in res]
    check_results(res, "stream")
    if launches or scan_launches != replayed + chunks or not scan_launches:
        raise RuntimeError(f"stream: {launches} pass1_step and "
                           f"{scan_launches} scan_win launches for "
                           f"{replayed} A* rounds run + {chunks} chunks")
    # where the stream's outprob rows differ from the batch path's
    rows = []
    for u, cache in enumerate(caches):
        n = int(nfr[u])
        d = (cache[:n] - batch_out[u, :cache.shape[0]][:n]).abs().amax(-1)
        rows.append(dict(frames_stream=int(cache.shape[0]), frames_batch=n,
                         max_abs_err=float(d.max()),
                         rows_over_1e_3=int((d > 1e-3).sum()),
                         first_row_over_1e_3=int(torch.nonzero(d > 1e-3)[0])
                         if (d > 1e-3).any() else -1))
    same = sum(r.words == b.words and abs(r.score - b.score) <= 0.5
               for r, b in zip(res, batch))
    full = [ms for n, ms in blocks if n == BLOCK]
    measured = path_kernels("stream", calls, {"pass1_step": launches,
                                              "word_end": we_launches,
                                              "scan_win": scan_launches},
                            eng, card)
    phase("stream", waveforms=N_STREAM, seconds_each=STREAM_S,
          block_frames=BLOCK, chunk_ms=CHUNK_SAMPLES / 16.0,
          words_equal_to_batch=f"{same}/{N_STREAM}",
          score_diff=[r.score - b.score for r, b in zip(res, batch)],
          words=[len(r.words) for r in res],
          from_pass2=sum(r.from_pass == 2 for r in res),
          blocks=len(blocks), full_blocks=len(full),
          ms_per_block_mean=sum(full) / len(full),
          ms_per_block_median=float(np.median(full)),
          ms_per_block_max=max(full), audio_ms_per_block=BLOCK * 10.0,
          segment_end_delay_ms=delays, stream_wall_s=walls,
          batch_wall_s=batch_s, outprob_rows=rows,
          frontend_stream_vs_batch_max_abs_err=fe_err,
          pass1_step_launches=launches,
          pass1_step_note="0: the stream's pass 1 takes the unfused step, "
                          "as the reference's stream runs XLA",
          scan_win_launches=scan_launches, astar_rounds=rounds,
          astar_replayed=replayed,
          rescan_chunks=chunks, card=card)
    if same != N_STREAM:
        raise RuntimeError(f"stream: {same}/{N_STREAM} equal to the batch "
                           "decode")
    return kernel_entries("stream", measured), (waves, batch)


def live_inputs(task_dir, files):
    """Inputs for the live phases beside the cli task: a waveform of 3
    noise bursts of 2 s between 1 s of near-silence (16 kHz, live.wav), a
    3 s 48 kHz tone in noise (in48.wav, listed in list48.txt), a -gmm
    model set of two classes (voice: the task's feature statistics;
    noise: far from them, gmmdefs) and HTK parameters of noise frames
    (noise.mfc).  -> ({name: path}, the waveform)."""
    import os

    from julius_tpu_torch.io.htk_param import (HTKParam, read_htk_param,
                                              write_htk_param)
    from julius_tpu_torch.io.wav import write_wav
    from julius_tpu_torch.tools.synth import write_class_gmm

    sr = 16000
    rng = np.random.default_rng(31)
    parts = [30.0 * rng.standard_normal(sr)]
    for _ in range(3):
        parts += [3000.0 * rng.standard_normal(2 * sr),
                  30.0 * rng.standard_normal(sr)]
    wave = np.concatenate(parts).astype(np.float32)
    out = {k: os.path.join(task_dir, v) for k, v in (
        ("wav", "live.wav"), ("wav48", "in48.wav"), ("list48", "list48.txt"),
        ("gmm", "gmmdefs"), ("noise", "noise.mfc"))}
    write_wav(out["wav"], wave, sr)
    t48 = np.arange(3 * 48000) / 48000
    write_wav(out["wav48"], (6000.0 * np.sin(2 * np.pi * 440 * t48)
                             + 500.0 * rng.standard_normal(t48.size))
              .astype(np.float32), 48000)
    with open(out["list48"], "w") as f:
        f.write(out["wav48"] + "\n")
    x = np.concatenate([read_htk_param(u).data for u in files["utts"]])
    write_class_gmm(out["gmm"], {"voice": (x.mean(0), x.var(0) + 0.5),
                                 "noise": (x.mean(0) + 30.0,
                                           np.ones(x.shape[1]))})
    noise = x.mean(0) + 30.0 + rng.standard_normal((80, x.shape[1]))
    write_htk_param(out["noise"], HTKParam(
        data=noise.astype(np.float32), samp_period=100000,
        kind="MFCC_E_D_A"))
    return out, wave


def segment_summary(det, chunks):
    """A segmenter's events on `chunks` -> ([(kind, samples of the
    segment)]: start, then the segment's sample count at its end; each
    finished segment's samples)."""
    out, segs, cur = [], [], []
    for c in chunks:
        for e in det.feed(c):
            if e["type"] == "samples":
                cur.append(e["data"])
            elif e["type"] == "start":
                out.append(("start", 0))
                cur = []
            else:
                segs.append(np.concatenate(cur))
                out.append(("end", len(segs[-1])))
    return out, segs


def stream_vad_phase(eng, card, files, live):
    """VAD-segmented decoding: a waveform of 3 noise bursts between
    near-silence fed to StreamSession with the VAD on the flagship
    engine (3 segments, each a valid result), the native segmenter's
    events against the Python segmenter's on the same samples; then on
    the cli task's GMM engine (loaded with -gmm -gmmnoise and
    -powerthres) the GMM-VAD gate over a feature stream and power
    rejection."""
    from julius_tpu_torch import fusion
    from julius_tpu_torch.adin import native_wrapper as nw
    from julius_tpu_torch.frontend.stream import SpeechDetector, VADConfig
    from julius_tpu_torch.io.htk_param import read_htk_param
    from julius_tpu_torch.jconf import parse_jconf
    from julius_tpu_torch.streaming import StreamSession

    paths, wave = live
    if not nw.native_available():
        raise RuntimeError("stream_vad: the native adin library did not "
                           "build")
    cfg = VADConfig(sample_rate=16000)
    chunks = [wave[o:o + CHUNK_SAMPLES]
              for o in range(0, len(wave), CHUNK_SAMPLES)]
    t0 = time.perf_counter()
    py, segs = segment_summary(SpeechDetector(cfg), chunks)
    py_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nat, _ = segment_summary(nw.NativeSpeechDetector(cfg), chunks)
    nat_s = time.perf_counter() - t0
    events = []
    ids = [eng.callbacks.add(name, lambda *a, _n=name: events.append(_n))
           for name in ("event_speech_start", "event_speech_stop")]
    try:
        with kept_loops() as loops:
            sess = StreamSession(eng, vad=cfg)
            t0 = time.perf_counter()
            res = []
            for c in chunks:
                res.extend(sess.feed(c))
            res.extend(sess.close())
            wall = time.perf_counter() - t0
    finally:
        for i in ids:
            eng.callbacks.delete(i)
    loops_vs_eager("stream_vad", loops, card)
    # each segment against recognize_batch on the segment's own samples
    # (a noise segment may end without </s> and come from pass 1, as it
    # would in the batch decode)
    seg_lens = np.asarray([len(x) for x in segs], np.int32)
    seg_wave = np.zeros((len(segs), max(seg_lens, default=1)), np.float32)
    for i, x in enumerate(segs):
        seg_wave[i, :len(x)] = x
    batch = eng.recognize_batch(seg_wave, seg_lens) if segs else []
    same = sum(r.words == b.words and abs(r.score - b.score) <= 0.5
               for r, b in zip(res, batch))
    for r in res:
        if not (r.valid and np.isfinite(r.score) and r.words):
            raise RuntimeError(f"bad stream_vad result {r}")

    # the GMM-VAD gate and -powerthres on the cli task's GMM engine
    utts = [read_htk_param(u).data for u in files["utts"][:2]]
    thres = 1.0
    argv = ["-h", files["am"], "-v", files["dict"], "-d", files["lm"],
            "-input", "mfcfile", "-gmm", paths["gmm"], "-gmmnoise", "noise",
            "-gmmup", "2.0", "-gmmdown", "-2.0", "-gmmmargin", "5",
            "-powerthres", str(thres)]
    geng = fusion.create_engines(parse_jconf(argv), device=DEVICE)[0]
    noise = read_htk_param(paths["noise"]).data
    frames = np.concatenate([noise[:40], utts[0], noise[40:], utts[1],
                             noise[:30]]).astype(np.float32)
    gsess = StreamSession(geng, use_vad=False, block_frames=BLOCK,
                          gmm_vad=True, gmm_margin=5)
    gres = []
    with kept_loops() as loops:
        for o in range(0, frames.shape[0], BLOCK):
            gres.extend(gsess._feed_gmm_vad(frames[o:o + BLOCK]))
        gres.extend(gsess.close())
    loops_vs_eager("stream_vad_gmm", loops, card)
    # one utterance with its average log energy (MFCC_E: column 12) put
    # above the threshold, the same one put below it
    batch = np.stack([utts[0], utts[0]])
    e = float(utts[0][:, 12].mean())
    batch[0, :, 12] += thres + 1.0 - e
    batch[1, :, 12] += thres - 1.0 - e
    pres = geng.decode_features(batch, [len(utts[0])] * 2)
    phase("stream_vad", seconds=len(wave) / 16000.0, segments=len(res),
          events=events, results=[dict(words=len(r.words), score=r.score,
                                       from_pass=r.from_pass) for r in res],
          equal_to_batch_of_segment=f"{same}/{len(res)}",
          segment_ranges=sess.segment_ranges, wall_s=wall,
          python_segments=py, native_segments=nat,
          native_equals_python=py == nat, python_segmenter_s=py_s,
          native_segmenter_s=nat_s,
          gmm_vad=dict(frames=int(frames.shape[0]), segments=len(gres),
                       ranges=gsess.segment_ranges,
                       valid=sum(r.valid and bool(r.words) for r in gres)),
          powerthres=dict(thres=thres, reasons=[r.reject_reason
                                                for r in pres]),
          card=card)
    if len(res) != 3 or py != nat or len(py) != 6 or same != 3 \
            or events != ["event_speech_start", "event_speech_stop"] * 3:
        raise RuntimeError(f"stream_vad: {len(res)} segments, native "
                           f"{nat} against Python {py}")
    if len(gres) != 2 or not all(r.valid and r.words for r in gres):
        raise RuntimeError(f"stream_vad: GMM-VAD gave {len(gres)} segments")
    if not pres[0].valid or pres[1].reject_reason != "low power":
        raise RuntimeError(f"stream_vad: -powerthres {pres}")


def cli_live_phase(card, files, live):
    """The command line's live and rejection paths on the cli task:
    -input fake:<wav> (capture, VAD, the streaming decode; `live segment
    N` blocks), -48 on a 48 kHz file, -gmm verification on a speech file
    and a noise file, -walign -palign -salign; the launch counts read
    around each run and its kernels held and timed at its shapes.
    Returns the kernels' entries."""
    from julius_tpu_torch.ops import pass1_kernel as pk
    from julius_tpu_torch.ops import scan_kernel as sk
    from julius_tpu_torch.ops import word_end_kernel as we
    from julius_tpu_torch.search import pass2_device as p2d
    from julius_tpu_torch.search import pass2_rescan as p2r
    from julius_tpu_torch.search import scan as scan_mod
    from julius_tpu_torch.tools import recognize

    paths, _ = live
    models = ["-h", files["am"], "-v", files["dict"], "-d", files["lm"],
              "-input", "mfcfile"]
    u0, u1 = files["utts"][:2]
    plan = (("cli_fake", ["-input", f"fake:{paths['wav']}"]),
            ("cli_48", ["-input", "rawfile", "-filelist", paths["list48"],
                        "-48"]),
            ("cli_gmm", ["-gmm", paths["gmm"], "-gmmreject", "noise", u0,
                         paths["noise"]]),
            ("cli_align", ["-walign", "-palign", "-salign", u0, u1]))
    runs, entries = {}, []
    for label, extra in plan:
        results = []
        with recorded_calls(pk, sk, p2d, scan_mod) as calls:
            pk.LAUNCHES = sk.LAUNCHES = we.LAUNCHES = p2r.CHUNKS = 0
            lines, wall, built = run_cli(recognize, models + extra, results)
            launches, scan_launches = pk.LAUNCHES, sk.LAUNCHES
            we_launches = we.LAUNCHES
        chunks = p2r.CHUNKS
        rounds, replayed = (calls["astar"][k] for k in ("rounds", "replayed"))
        if scan_launches != replayed + chunks or not scan_launches \
                or (launches == 0) != (label == "cli_fake"):
            raise RuntimeError(f"{label}: {launches} pass1_step and "
                               f"{scan_launches} scan_win launches for "
                               f"{replayed} A* rounds run + {chunks} "
                               "chunks")
        heads = [ln for ln in lines if ln.startswith("input: ")]
        runs[label] = dict(
            wall_s=wall, inputs=len(heads),
            sentences=sum(ln.startswith("sentence1:") for ln in lines),
            rejected=lines.count("<input rejected by decoder>"),
            live_segments=sum("live segment" in h for h in heads),
            alignment_blocks=sum(ln.startswith("=== ") for ln in lines),
            results=len(results), kernel_launches=launches,
            scan_win_launches=scan_launches, astar_rounds=rounds,
            astar_replayed=replayed,
            rescan_chunks=chunks)
        entries += kernel_entries(label, path_kernels(
            label, calls, {"pass1_step": launches, "word_end": we_launches,
                           "scan_win": scan_launches}, built[0], card))
        del calls, built
    phase("cli_live", runs=runs, card=card)
    want = {"cli_fake": dict(inputs=3, sentences=3, rejected=0,
                             live_segments=3),
            "cli_48": dict(inputs=1, sentences=1, rejected=0),
            "cli_gmm": dict(inputs=2, sentences=1, rejected=1),
            "cli_align": dict(inputs=2, sentences=2, rejected=0,
                              alignment_blocks=6)}
    for label, fields in want.items():
        if any(runs[label][k] != v for k, v in fields.items()):
            raise RuntimeError(f"{label}: {runs[label]}")
    return entries



# ---- the server slice: the module protocol, adinnet, vecnet, grammar
# changes over the socket, and the tools

MODULE_TIMEOUT_S = 300        # a module client's wait for one reply


class PortWatch:
    """A log stream that picks serve()'s "module port X, adinnet port Y"
    line out of the log."""

    def __init__(self):
        import queue
        self.ports = queue.Queue()

    def write(self, s):
        m = re.search(r"module port (\d+), adinnet port (\d+)", s)
        if m:
            self.ports.put((int(m.group(1)), int(m.group(2))))
        return len(s)

    def flush(self):
        pass


def read_msg(f) -> str:
    """One module message: the lines up to a line holding a single '.'."""
    lines = []
    while True:
        line = f.readline()
        if not line:
            raise RuntimeError(f"module connection closed after {lines}")
        if line.strip() == b".":
            return b"\n".join(lines).decode()
        lines.append(line.rstrip(b"\n"))


def command(f, sock, text, want):
    """Send a module command (with any body) and hold its reply to the
    reference's message -> seconds to the reply."""
    t0 = time.perf_counter()
    sock.sendall(text.encode())
    got = read_msg(f)
    wall = time.perf_counter() - t0
    if got != want:
        raise RuntimeError(f"{text.splitlines()[0]}: {got!r}, the "
                           f"reference's message is {want!r}")
    return wall


@contextlib.contextmanager
def serving(engines):
    """tools.serve.serve(engines) on a thread, its ports chosen by the
    system, and a module client connected to it: yields (the client's
    file, its socket, the adinnet port).  On leaving, waits for serve()
    to return (its adinnet client must have closed), then sends DIE."""
    import importlib
    import socket
    import threading

    from julius_tpu_torch.tools.serve import serve

    jlog = importlib.import_module("julius_tpu_torch.utils.jlog")
    watch, box = PortWatch(), {}

    def run():
        try:
            box["mod"] = serve(engines, module_port=0, adin_port=0)
        except BaseException as e:
            box["error"] = e
            raise

    t = threading.Thread(target=run, daemon=True)
    jlog.set_log_output(watch)
    try:
        t.start()
        mport, aport = watch.ports.get(timeout=MODULE_TIMEOUT_S)
    finally:
        jlog.set_log_output(jlog.DEFAULT)
    sock = socket.create_connection(("127.0.0.1", mport))
    sock.settimeout(MODULE_TIMEOUT_S)
    f = sock.makefile("rb")
    try:
        yield f, sock, aport
        t.join(timeout=MODULE_TIMEOUT_S)
        if t.is_alive() or "error" in box:
            raise RuntimeError(f"serve() did not end: {box.get('error')}")
        sock.sendall(b"DIE\n")
    finally:
        f.close()
        sock.close()
        if "mod" in box:
            box["mod"]._srv.close()


def recogout_words(msg: str):
    """The rank-1 words of a <RECOGOUT> message; None for <RECOGFAIL/>."""
    if msg.startswith("<RECOGFAIL"):
        return None
    if not msg.startswith("<RECOGOUT>"):
        raise RuntimeError(f"not a result message: {msg!r}")
    return re.findall(r'CLASSID="([^"]*)"', msg.split("</SHYPO>")[0])


def same_as_batch(msgs, batch) -> int:
    """Results equal to the batch decode: the same rank-1 words, or a
    <RECOGFAIL/> where the batch result is invalid."""
    return sum((recogout_words(m) == b.words) if b.valid
               else recogout_words(m) is None for m, b in zip(msgs, batch))


def server_phase(eng, card, stream_in, live):
    """`julius -module -input adinnet` on the card: tools.serve.serve on
    the flagship engine, a module client's control commands held to the
    reference's replies, the stream phase's 4 waveforms sent over
    adinnet as 4 segments (each <RECOGOUT> held to that phase's
    recognize_batch), then tools.adintool on the three-burst waveform
    (one result for each segment it sends, each equal to recognize_batch
    on that segment's samples).  scan_win held and timed at the shapes
    each part gave it.  Returns the kernels' entries."""
    import io

    from julius_tpu_torch.ops import pass1_kernel as pk
    from julius_tpu_torch.ops import scan_kernel as sk
    from julius_tpu_torch.ops import word_end_kernel as we
    from julius_tpu_torch.search import pass1 as p1
    from julius_tpu_torch.search import pass2_device as p2d
    from julius_tpu_torch.search import pass2_rescan as p2r
    from julius_tpu_torch.search import scan as scan_mod
    from julius_tpu_torch.server.adinnet import AdinnetClient
    from julius_tpu_torch.tools import adintool

    t_phase = time.perf_counter()
    waves, batch = stream_in
    control = (
        ("STATUS\n", '<SYSINFO PROCESS="ACTIVE"/>'),
        ("VERSION\n", '<ENGINEINFO TYPE="julius_tpu_torch" VERSION="r1" '
                      'CONF="cuda"/>'),
        ("LISTPROCESS\n", '<PROCESSLIST>\n  <PROCESS ID="0" '
                          'NAME="_default" LMTYPE="ngram" STATUS="ACTIVE"/>'
                          '\n</PROCESSLIST>'),
        ("PAUSE\n", '<SYSINFO PROCESS="SLEEP"/>'),
        ("RESUME\n", '<SYSINFO PROCESS="ACTIVE"/>'))
    marks = []
    real_finalize = p1.pass1_stream_finalize

    def finalize(*a, **kw):
        marks.append(time.perf_counter())
        return real_finalize(*a, **kw)

    runs, entries = {}, []
    # the stream phase's waveforms, one segment each, over adinnet
    msgs, sent_to_result, end_to_result = [], [], []
    p1.pass1_stream_finalize = finalize
    try:
        with serving([eng]) as (f, sock, aport):
            control_s = sum(command(f, sock, c, w) for c, w in control)
            cli = AdinnetClient(port=aport)
            with recorded_calls(pk, sk, p2d, scan_mod) as calls:
                pk.LAUNCHES = sk.LAUNCHES = we.LAUNCHES = p2r.CHUNKS = 0
                t0 = time.perf_counter()
                for w in waves:
                    cli.send_samples(w)
                    cli.send_segment_end()
                    t_sent = time.perf_counter()
                    msgs.append(read_msg(f))
                    t_got = time.perf_counter()
                    sent_to_result.append((t_got - t_sent) * 1e3)
                    end_to_result.append((t_got - marks[-1]) * 1e3)
                wall = time.perf_counter() - t0
                launches, scan_launches = pk.LAUNCHES, sk.LAUNCHES
                we_launches = we.LAUNCHES
            cli.close()
    finally:
        p1.pass1_stream_finalize = real_finalize
    chunks = p2r.CHUNKS
    rounds, replayed = (calls["astar"][k] for k in ("rounds", "replayed"))
    if launches or scan_launches != replayed + chunks or not scan_launches:
        raise RuntimeError(f"server: {launches} pass1_step and "
                           f"{scan_launches} scan_win launches for "
                           f"{replayed} A* rounds run + {chunks} chunks")
    same = same_as_batch(msgs, batch)
    runs["server"] = dict(
        segments=len(msgs), seconds_each=STREAM_S,
        equal_to_recognize_batch=f"{same}/{len(batch)}",
        recogfail=sum(m.startswith("<RECOGFAIL") for m in msgs),
        segment_end_sent_to_result_ms=sent_to_result,
        segment_end_delay_ms=end_to_result, wall_s=wall,
        control_commands_s=control_s, pass1_step_launches=launches,
        scan_win_launches=scan_launches, astar_rounds=rounds,
        astar_replayed=replayed,
        rescan_chunks=chunks)
    entries += kernel_entries("server", path_kernels(
        "server", calls, {"pass1_step": launches, "word_end": we_launches,
                          "scan_win": scan_launches}, eng, card))
    del calls
    if same != len(batch):
        raise RuntimeError(f"server: {same}/{len(batch)} results equal to "
                           "recognize_batch")

    # adintool feeding the server: the segments it sends are recorded
    paths, _ = live
    sent = []

    class RecordingClient(AdinnetClient):
        def send_samples(self, samples, chunk=4096):
            sent.append(np.clip(np.asarray(samples), -32768, 32767)
                        .astype(np.int16).astype(np.float32))
            super().send_samples(samples, chunk)

    out = io.StringIO()
    with serving([eng]) as (f, sock, aport):
        with recorded_calls(pk, sk, p2d, scan_mod) as calls:
            pk.LAUNCHES = sk.LAUNCHES = we.LAUNCHES = p2r.CHUNKS = 0
            real_client = adintool.AdinnetClient
            adintool.AdinnetClient = RecordingClient
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(out):
                    rc = adintool.main(["-in", "file", "-filename",
                                        paths["wav"], "-out", "adinnet",
                                        "-server", f"127.0.0.1:{aport}"],
                                       device=DEVICE)
            finally:
                adintool.AdinnetClient = real_client
            msgs = [read_msg(f) for _ in sent]
            wall = time.perf_counter() - t0
            launches, scan_launches = pk.LAUNCHES, sk.LAUNCHES
            we_launches = we.LAUNCHES
    chunks = p2r.CHUNKS
    rounds, replayed = (calls["astar"][k] for k in ("rounds", "replayed"))
    said = out.getvalue().strip()
    if rc != 0 or said != f"sent {len(sent)} segment(s) over adinnet" \
            or len(sent) != 3:
        raise RuntimeError(f"adintool: rc {rc}, {said!r}, {len(sent)} "
                           "segments recorded (3 expected)")
    if launches or scan_launches != replayed + chunks or not scan_launches:
        raise RuntimeError(f"server_adintool: {launches} pass1_step and "
                           f"{scan_launches} scan_win launches for "
                           f"{replayed} A* rounds run + {chunks} chunks")
    lens = np.asarray([len(x) for x in sent], np.int32)
    padded = np.zeros((len(sent), lens.max()), np.float32)
    for u, x in enumerate(sent):
        padded[u, :len(x)] = x
    batch = eng.recognize_batch(padded, lens)
    same = same_as_batch(msgs, batch)
    runs["server_adintool"] = dict(
        segments=len(sent), samples=lens.tolist(),
        equal_to_recognize_batch=f"{same}/{len(sent)}",
        recogfail=sum(m.startswith("<RECOGFAIL") for m in msgs),
        wall_s=wall, pass1_step_launches=launches,
        scan_win_launches=scan_launches, astar_rounds=rounds,
        astar_replayed=replayed,
        rescan_chunks=chunks)
    entries += kernel_entries("server_adintool", path_kernels(
        "server_adintool", calls, {"pass1_step": launches,
                                   "word_end": we_launches,
                                   "scan_win": scan_launches}, eng, card))
    phase("server", runs=runs, phase_s=time.perf_counter() - t_phase,
          card=card)
    if same != len(sent):
        raise RuntimeError(f"server_adintool: {same}/{len(sent)} results "
                           "equal to recognize_batch")
    return entries


def vecnet_transfer(rows, outprob):
    """Each [T, D] array of `rows` sent as one segment by a VecnetClient
    to a VecnetServer on a thread -> (the segments it received, its
    configuration (veclen, fshift_ms, is_outprob), seconds)."""
    import threading

    from julius_tpu_torch.server.vecnet import VecnetClient, VecnetServer

    srv = VecnetServer(port=0)
    got = {"segments": []}

    def run():
        srv.accept()
        got["conf"] = (srv.veclen, srv.fshift_ms, srv.is_outprob)
        cur = []
        for kind, v in srv.events():
            if kind == "vector":
                cur.append(v)
            elif kind == "segment":
                got["segments"].append(np.stack(cur))
                cur = []
            else:
                break

    t = threading.Thread(target=run, daemon=True)
    t0 = time.perf_counter()
    t.start()
    cli = VecnetClient(veclen=rows[0].shape[1], port=srv.port,
                       outprob=outprob)
    for r in rows:
        cli.send_frames(r)
        cli.send_segment_end()
    cli.send_stream_end()
    cli.close()
    t.join(timeout=MODULE_TIMEOUT_S)
    wall = time.perf_counter() - t0
    srv.close()
    if t.is_alive():
        raise RuntimeError("vecnet: the server did not reach the stream end")
    return got["segments"], got["conf"], wall


def vecnet_phase(eng, card, feats, lens_np, truths, first):
    """vecnet input: the 16 flagship utterances' feature rows that the
    slice decoded first, one segment each, from a VecnetClient to a
    VecnetServer on a thread, decoded as one batch by decode_features
    (at least 15/16 exact, the words of the first decode); then the
    utterances' senone rows (compute_outprob) sent in the outprob mode
    and decoded by decode_outprob (the same words).  Both kernels held
    and timed at the shapes each decode gave them.  Returns the
    kernels' entries."""
    from julius_tpu_torch.ops import pass1_kernel as pk
    from julius_tpu_torch.ops import scan_kernel as sk
    from julius_tpu_torch.ops import word_end_kernel as we
    from julius_tpu_torch.search import pass2_device as p2d
    from julius_tpu_torch.search import pass2_rescan as p2r
    from julius_tpu_torch.search import scan as scan_mod

    t_phase = time.perf_counter()
    host = feats.cpu().numpy()
    runs, entries = {}, []
    with torch.no_grad():
        rows_all = eng.compute_outprob(feats)
    for label, outprob, array in (("vecnet", False, host),
                                  ("vecnet_outprob", True, rows_all)):
        rows = [array[u, :n] for u, n in enumerate(lens_np)]
        segs, conf, send_s = vecnet_transfer(rows, outprob)
        if conf != (array.shape[-1], 10, outprob) or len(segs) != N_UTTS \
                or any(not np.array_equal(a, b) for a, b in zip(segs, rows)):
            raise RuntimeError(f"{label}: configuration {conf}, "
                               f"{len(segs)} segments, rows differ")
        lens = np.asarray([x.shape[0] for x in segs], np.int32)
        batch = np.zeros((N_UTTS, lens.max(), array.shape[-1]), np.float32)
        for u, x in enumerate(segs):
            batch[u, :len(x)] = x
        decode = eng.decode_outprob if outprob else eng.decode_features
        torch.cuda.synchronize()
        with recorded_calls(pk, sk, p2d, scan_mod) as calls:
            pk.LAUNCHES = sk.LAUNCHES = we.LAUNCHES = p2r.CHUNKS = 0
            t0 = time.perf_counter()
            res = decode(batch, lens)
            decode_s = time.perf_counter() - t0
            launches, scan_launches = pk.LAUNCHES, sk.LAUNCHES
            we_launches = we.LAUNCHES
        chunks = p2r.CHUNKS
        rounds, replayed = (calls["astar"][k] for k in ("rounds", "replayed"))
        if launches != lens.max() or scan_launches != replayed + chunks \
                or not scan_launches:
            raise RuntimeError(f"{label}: {launches} pass1_step launches "
                               f"for {lens.max()} frames, {scan_launches} "
                               f"scan_win for {replayed} rounds run + "
                               f"{chunks}")
        check_results(res, label)
        exact = exact_count(res, truths)
        equal = sum(r.word_ids == w.word_ids for r, w in zip(res, first))
        runs[label] = dict(
            veclen=conf[0], outprob=conf[2], utterances=N_UTTS,
            frames=int(lens.sum()), send_s=send_s, decode_s=decode_s,
            exact_transcripts=f"{exact}/{N_UTTS}",
            equal_to_first_decode=f"{equal}/{N_UTTS}",
            pass1_step_launches=launches, scan_win_launches=scan_launches,
            astar_rounds=rounds, astar_replayed=replayed, rescan_chunks=chunks)
        entries += kernel_entries(label, path_kernels(
            label, calls, {"pass1_step": launches, "word_end": we_launches,
                           "scan_win": scan_launches}, eng, card))
        del calls
        if exact < N_UTTS - 1 or equal != N_UTTS:
            raise RuntimeError(f"{label}: {runs[label]}")
    phase("vecnet", runs=runs, phase_s=time.perf_counter() - t_phase,
          card=card)
    return entries


def server_grammar_phase(card, files):
    """Grammar changes over the module socket: the cli phase's GMM
    grammar task (-h am.binhmm -gram gram, 5000 words) served by a
    ModuleServer on a thread; GRAMINFO, CHANGEGRAM with the task's
    gram.dfa / gram.dict, ADDGRAM of a second copy, DEACTIVATEGRAM,
    ACTIVATEGRAM, SYNCGRAM, ADDWORD and DELGRAM, each reply held to the
    reference's message, each rebuild (the full-width network on the
    card, from the command loop's thread) timed; then the switched
    engine decodes the 4 grammar utterances (exact, accepted by its
    automaton).  Returns the kernels' entries."""
    import socket
    import threading

    from julius_tpu_torch import fusion
    from julius_tpu_torch.jconf import parse_jconf
    from julius_tpu_torch.io.htk_param import read_htk_param
    from julius_tpu_torch.ops import pass1_kernel as pk
    from julius_tpu_torch.ops import scan_kernel as sk
    from julius_tpu_torch.ops import word_end_kernel as we
    from julius_tpu_torch.search import pass2_device as p2d
    from julius_tpu_torch.search import pass2_rescan as p2r
    from julius_tpu_torch.search import scan as scan_mod
    from julius_tpu_torch.server.module import ModuleServer

    t_phase = time.perf_counter()
    gf, truths = files["gram_task"], files["gram_truths"]
    t0 = time.perf_counter()
    geng = fusion.create_engines(parse_jconf(["-h", files["am"], "-gram",
                                              gf["gram"]]), device=DEVICE)[0]
    build_s = time.perf_counter() - t0
    if geng.lmtype != "grammar":
        raise RuntimeError(f"server_grammar: lmtype {geng.lmtype}")
    n_w, n_s = geng.voca.n_words, geng.dfa.n_states
    with open(gf["dfa"]) as fh:
        dfa_text = fh.read()
    with open(gf["gram_dict"]) as fh:
        dict_text = fh.read()
    body = dfa_text + dict_text + "DICEND\n"
    # a new word of an existing category whose phones are two words'
    # reversed: no grammar utterance says it
    v = geng.voca
    new_word = (f"{v.names[2]}\t[added]\t"
                + " ".join(v.phones[2][::-1] + v.phones[3][::-1]))
    ready = '<GRAMMAR STATUS="READY"/>'
    steps = (
        ("graminfo", "GRAMINFO\n", f'<GRAMINFO>\n  #0: [active] {n_w} '
         f'words, {n_s} states "startup"\n</GRAMINFO>', n_w),
        ("changegram", f"CHANGEGRAM g1\n{body}",
         '<GRAMMAR STATUS="RECEIVED" ID="1"/>', n_w),
        ("addgram", f"ADDGRAM g2\n{body}",
         '<GRAMMAR STATUS="RECEIVED" ID="2"/>', 2 * n_w),
        ("deactivategram", "DEACTIVATEGRAM 2\n", ready, n_w),
        ("activategram", "ACTIVATEGRAM 2\n", ready, 2 * n_w),
        ("syncgram", "SYNCGRAM\n", ready, 2 * n_w),
        ("addword", f"ADDWORD 1\n{new_word}\nDICEND\n",
         '<GRAMMAR STATUS="WORDADDED" NUM="1"/>', 2 * n_w + 1),
        ("delgram", "DELGRAM 2\n", ready, n_w + 1),
        ("graminfo_after", "GRAMINFO\n", f'<GRAMINFO>\n  #1: [active] '
         f'{n_w + 1} words, {n_s} states "g1"\n</GRAMINFO>', n_w + 1))
    srv = ModuleServer([geng], port=0)
    t = threading.Thread(target=lambda: (srv.accept(), srv.serve_forever()),
                         daemon=True)
    t.start()
    sock = socket.create_connection(("127.0.0.1", srv.port))
    sock.settimeout(MODULE_TIMEOUT_S)
    f = sock.makefile("rb")
    walls = {}
    try:
        for label, text, want, words in steps:
            walls[label] = command(f, sock, text, want)
            e = srv.engines[0]
            on = e.dev_net.score_idx.device
            if e.voca.n_words != words or e.device != geng.device \
                    or on.type != torch.device(DEVICE).type:
                raise RuntimeError(f"{label}: the engine has "
                                   f"{e.voca.n_words} words on {on}")
        eng = srv.engines[0]
        frames = [read_htk_param(p).data for p in gf["gram_utts"]]
        lens = np.asarray([x.shape[0] for x in frames], np.int32)
        feats = np.zeros((len(frames), lens.max(), frames[0].shape[1]),
                         np.float32)
        for u, x in enumerate(frames):
            feats[u, :len(x)] = x
        torch.cuda.synchronize()
        with recorded_calls(pk, sk, p2d, scan_mod) as calls:
            pk.LAUNCHES = sk.LAUNCHES = we.LAUNCHES = p2r.CHUNKS = 0
            t0 = time.perf_counter()
            res = eng.decode_features(feats, lens)
            decode_s = time.perf_counter() - t0
            launches, scan_launches = pk.LAUNCHES, sk.LAUNCHES
            we_launches = we.LAUNCHES
        chunks = p2r.CHUNKS
        sock.sendall(b"DIE\n")
        t.join(timeout=MODULE_TIMEOUT_S)
    finally:
        f.close()
        sock.close()
        srv._srv.close()
    if launches or scan_launches != chunks or not scan_launches:
        raise RuntimeError(f"server_grammar: {launches} pass1_step and "
                           f"{scan_launches} scan_win launches for {chunks} "
                           "re-scan chunks")
    check_results(res, "server_grammar", edges="texts")
    exact = sum([t for t in r.texts if t] == w for r, w in zip(res, truths))
    accepted = sum(eng.dfa.accepts_forward([int(eng.word_cat[w])
                                            for w in r.word_ids])
                   for r in res)
    measured = path_kernels("server_grammar", calls, {
        "pass1_step": launches, "word_end": we_launches,
        "scan_win": scan_launches}, eng, card)
    phase("server_grammar", engine_build_s=build_s, words=n_w,
          dfa_states=n_s, nodes=int(geng.dev_net.score_idx.shape[0]),
          reply_s=walls, utterances=len(res),
          exact_transcripts=f"{exact}/{len(res)}",
          dfa_accepted=f"{accepted}/{len(res)}", decode_s=decode_s,
          from_pass2=sum(r.from_pass == 2 for r in res),
          scan_win_launches=scan_launches, rescan_chunks=chunks,
          phase_s=time.perf_counter() - t_phase, card=card)
    if exact != len(res) or accepted != len(res):
        raise RuntimeError(f"server_grammar: {exact} exact, {accepted} "
                           f"accepted of {len(res)}")
    return kernel_entries("server_grammar", measured)


def trace_busy(path):
    """From a Chrome trace of torch.profiler: the window from its first
    to its last event, and the share of it in which the card runs a
    kernel (the union of the kernels' spans)."""
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    lo = min(e["ts"] for e in events)
    hi = max(e["ts"] + e["dur"] for e in events)
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "kernel")
    busy, end = 0.0, -np.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return dict(window_ms=(hi - lo) / 1e3, kernel_busy_ms=busy / 1e3,
                busy_share=busy / (hi - lo), kernels=len(spans),
                events=len(events))


PLUGIN = """import json
import pathlib

OUT = pathlib.Path({out!r})
BEST = []


def result_best_str(s):
    BEST.append(s)
    OUT.write_text(json.dumps(BEST))
"""


def tools_phase(eng, card, files):
    """The tools on the card: tools.profile's stages on the flagship at
    B = 32 x 10 s (its default), then the same under its trace option,
    and the share of the traced window in which the card runs a kernel;
    recognize.main on the cli task with -check triphone and a
    -plugindir whose plugin receives each best string (equal to the
    printed sentence1 lines), its kernels held and timed at its shapes;
    wer.synthetic_eval(n_utts=8) on the card equal to the CPU's.
    Returns the kernels' entries."""
    import os

    from julius_tpu_torch.ops import pass1_kernel as pk
    from julius_tpu_torch.ops import scan_kernel as sk
    from julius_tpu_torch.ops import word_end_kernel as we
    from julius_tpu_torch.search import pass2_device as p2d
    from julius_tpu_torch.search import pass2_rescan as p2r
    from julius_tpu_torch.search import scan as scan_mod
    from julius_tpu_torch.tools import profile, recognize, wer

    walls = {}
    t_phase = time.perf_counter()
    rng = np.random.default_rng(0)
    wave = (rng.standard_normal((32, 160000)) * 2000).astype(np.float32)
    lengths = np.full(32, 160000, np.int32)
    stages = profile.profile_stages(eng, wave, lengths)
    walls["profile_s"] = time.perf_counter() - t_phase
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tools_")
    try:
        t0 = time.perf_counter()
        traced = profile.trace_stages(eng, wave, lengths, tmp)
        walls["trace_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        busy = trace_busy(os.path.join(tmp, profile.TRACE_FILE))
        walls["trace_read_s"] = time.perf_counter() - t0
        busy["trace_mb"] = os.path.getsize(
            os.path.join(tmp, profile.TRACE_FILE)) / 2 ** 20

        # -check triphone and a result-receiving plugin
        pdir = os.path.join(tmp, "plugins")
        os.mkdir(pdir)
        best_path = os.path.join(tmp, "best.json")
        with open(os.path.join(pdir, "recv.py"), "w") as fh:
            fh.write(PLUGIN.format(out=best_path))
        argv = ["-h", files["am"], "-v", files["dict"], "-d", files["lm"],
                "-input", "mfcfile", "-batchsize", str(N_SIDE), "-check",
                "triphone", "-plugindir", pdir] + files["utts"][:N_SIDE]
        results = []
        with recorded_calls(pk, sk, p2d, scan_mod) as calls:
            pk.LAUNCHES = sk.LAUNCHES = we.LAUNCHES = p2r.CHUNKS = 0
            p2d.LAST_STATS.clear()
            lines, wall, built = run_cli(recognize, argv, results)
            launches, scan_launches = pk.LAUNCHES, sk.LAUNCHES
            we_launches = we.LAUNCHES
        with open(best_path) as fh:
            best = json.load(fh)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check_results(results, "cli_plugin")
    printed = [ln.split(": ", 1)[1] for ln in lines
               if ln.startswith("sentence1: ")]
    check = json.loads(lines[0].split(": ", 1)[1]) \
        if lines and lines[0].startswith("-check triphone: ") else None
    entries = kernel_entries("cli_plugin", path_kernels(
        "cli_plugin", calls, {"pass1_step": launches, "word_end": we_launches,
                              "scan_win": scan_launches}, built[0], card))
    del calls, built

    t0 = time.perf_counter()
    on_card = wer.synthetic_eval(n_utts=8, device=DEVICE)
    card_s = time.perf_counter() - t0
    on_cpu = wer.synthetic_eval(n_utts=8, device="cpu")
    phase("tools", profile_stages=stages, profile_traced_stages=traced,
          profile_trace=busy, batch=32, seconds_each=10.0,
          cli_plugin=dict(wall_s=wall, files=N_SIDE, check_triphone=check,
                          plugin_best_equal_to_sentence1=best == printed,
                          pass1_step_launches=launches,
                          scan_win_launches=scan_launches),
          wer_card=str(on_card), wer_cpu=str(on_cpu), wer_card_s=card_s,
          walls=walls, phase_s=time.perf_counter() - t_phase, card=card)
    if best != printed or len(best) != N_SIDE or check is None \
            or check["missing"]:
        raise RuntimeError(f"cli_plugin: plugin {best}, printed {printed}, "
                           f"-check {check}")
    if vars(on_card) != vars(on_cpu):
        raise RuntimeError(f"synthetic_eval: card {on_card}, CPU {on_cpu}")
    if not all(np.isfinite(v) and v > 0 for v in stages.values()):
        raise RuntimeError(f"profile_stages: {stages}")
    return entries


def backward_phase(eng, feats, lens_np, truths, res, card, files):
    """A backward (RL) N-gram for pass 2.  The flagship engine with the
    flagship 2-gram flipped into a backward model (tools.synth
    backward_ngram) as `lm` and the flagship 2-gram as `lm_forward`
    decodes the slice's 16 utterances (pass 1 on the forward 2-gram
    through the beam-update kernel, pass 2 the frozen backward stack
    search on the host); then the port's CPU decode of 4 of them from
    the card's outprob rows; recognize.main with -nlr + -nrl ARPA files
    on the cli task's 4 files; and register_user_lm with a Python
    2-gram on 4 flagship utterances (the host re-scan, whose chunks
    launch scan_win).  Returns the kernels' entries."""
    import os

    from julius_tpu_torch.engine import Engine
    from julius_tpu_torch.io.arpa import write_arpa
    from julius_tpu_torch.io.bingram import read_bingram
    from julius_tpu_torch.io.htk_param import read_htk_param
    from julius_tpu_torch.ops import pass1_kernel as pk
    from julius_tpu_torch.ops import scan_kernel as sk
    from julius_tpu_torch.ops import word_end_kernel as we
    from julius_tpu_torch.search import pass1 as p1
    from julius_tpu_torch.search import pass2_device as p2d
    from julius_tpu_torch.search import pass2_rescan as p2r
    from julius_tpu_torch.search import scan as scan_mod
    from julius_tpu_torch.tools import recognize
    from julius_tpu_torch.tools.synth import backward_ngram

    t_phase = time.perf_counter()
    kw = dict(dnn=eng.dnn_params, frontend=eng.fe_cfg,
              search=eng.search_cfg)
    bwd = backward_ngram(eng.lm)
    t0 = time.perf_counter()
    beng = Engine(eng.hmm, eng.voca, bwd, lm_forward=eng.lm, device=DEVICE,
                  **kw)
    build_s = time.perf_counter() - t0
    if beng.lm_p1 is not eng.lm or beng._rescan_ok() \
            or not p1.fused_ok(beng.dev_net, beng.p1_cfg):
        raise RuntimeError("backward: the engine does not pair the "
                           "forward 2-gram with the frozen backward search")
    T = feats.shape[1]
    beng.decode_features(feats[:2], lens_np[:2])        # warm-up
    torch.cuda.synchronize()
    with recorded_calls(pk, sk, p2d, scan_mod) as calls:
        pk.LAUNCHES = sk.LAUNCHES = we.LAUNCHES = 0
        t0 = time.perf_counter()
        bres = beng.decode_features(feats, lens_np)
        wall = time.perf_counter() - t0
        launches, scan_launches = pk.LAUNCHES, sk.LAUNCHES
        we_launches = we.LAUNCHES
    if launches != T or scan_launches != 0:
        raise RuntimeError(f"backward: {launches} pass1_step launches for "
                           f"{T} frames, {scan_launches} scan_win")
    check_results(bres, "backward")
    exact = exact_count(bres, truths)
    from_pass2 = sum(r.from_pass == 2 for r in bres)
    # the same decode staged: DNN, pass 1, the backward host search
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        out_ext = beng._outprob(feats)
    torch.cuda.synchronize()
    dnn_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tr = beng._pass1(out_ext, lens_np)
    torch.cuda.synchronize()
    p1_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with torch.no_grad():
        staged = beng._results(tr, lens_np, out_ext=out_ext)
    search_s = time.perf_counter() - t0
    if [r.word_ids for r in staged] != [r.word_ids for r in bres]:
        raise RuntimeError("backward: staged decode differs")
    measured = path_kernels("backward", calls, {"pass1_step": launches,
                                                "word_end": we_launches,
                                                "scan_win": scan_launches},
                            beng, card)
    entries = kernel_entries("backward", measured)

    # the port's own CPU decode of 4 of them, on the card's outprob rows
    t0 = time.perf_counter()
    cpu = Engine(eng.hmm, eng.voca, bwd, lm_forward=eng.lm, device="cpu",
                 **kw)
    side = slice(0, N_SIDE)
    cres = cpu.decode_outprob(out_ext[side].cpu(), lens_np[side])
    cpu_s = time.perf_counter() - t0
    cpu_same = [r.word_ids for r in cres] == [r.word_ids for r in
                                              bres[side]]
    cpu_err = max(abs(a.score - b.score) for a, b in zip(cres, bres[side]))
    del cpu

    # the command line with -nlr + -nrl ARPA files on the cli task
    runs = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_nrl_")
    try:
        t0 = time.perf_counter()
        fwd = read_bingram(files["lm"])
        fwd_path = os.path.join(tmp, "fwd.arpa")
        back_path = os.path.join(tmp, "back.arpa")
        write_arpa(fwd, fwd_path)
        write_arpa(backward_ngram(fwd), back_path)
        arpa_s = time.perf_counter() - t0
        inputs = files["utts"][:N_SIDE]
        argv = ["-h", files["am"], "-v", files["dict"], "-nlr", fwd_path,
                "-nrl", back_path, "-input", "mfcfile", "-batchsize",
                str(N_SIDE)] + inputs
        results = []
        with recorded_calls(pk, sk, p2d, scan_mod) as calls:
            pk.LAUNCHES = sk.LAUNCHES = we.LAUNCHES = 0
            lines, cli_wall, built = run_cli(recognize, argv, results)
            cli_launches, cli_scan = pk.LAUNCHES, sk.LAUNCHES
            cli_we = we.LAUNCHES
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t_run = max(read_htk_param(f).data.shape[0] for f in inputs)
    if cli_launches != t_run or cli_scan != 0:
        raise RuntimeError(f"cli_nrl: {cli_launches} pass1_step launches for "
                           f"{t_run} frames, {cli_scan} scan_win")
    check_results(results, "cli_nrl")
    got = [ln.split(": ", 1)[1] if ": " in ln else ""
           for ln in lines if ln.startswith("sentence1:")]
    want = [" ".join(w for w in t if w not in ("<s>", "</s>"))
            for t in files["truths"][:N_SIDE]]
    runs["cli_nrl"] = dict(
        files=N_SIDE, wall_s=cli_wall, arpa_write_s=arpa_s,
        exact_transcripts=f"{sum(g == w for g, w in zip(got, want))}/"
                          f"{N_SIDE}",
        from_pass2=sum(r.from_pass == 2 for r in results),
        pass1_step_launches=cli_launches, scan_win_launches=cli_scan)
    entries += kernel_entries("cli_nrl", path_kernels(
        "cli_nrl", calls, {"pass1_step": cli_launches, "word_end": cli_we,
                           "scan_win": cli_scan}, built[0], card))
    del calls, built

    # an application LM for pass 2 (register_user_lm): the flagship
    # 2-gram as a Python function of dictionary ids
    m = eng._wid2lm
    lm = eng.lm

    def user_lm(ctx, w):
        return lm.logprob(tuple(int(m[c]) for c in ctx[-1:]), int(m[w]))

    beng.register_user_lm(user_lm)
    if not beng._rescan_ok() or beng._device_astar_ok():
        raise RuntimeError("user LM: pass 2 is not the host re-scan")
    with recorded_calls(pk, sk, p2d, scan_mod) as calls:
        pk.LAUNCHES = sk.LAUNCHES = we.LAUNCHES = p2r.CHUNKS = 0
        t0 = time.perf_counter()
        ures = beng.decode_features(feats[side], lens_np[side])
        user_wall = time.perf_counter() - t0
        u_launches, u_scan, u_chunks = pk.LAUNCHES, sk.LAUNCHES, p2r.CHUNKS
        u_we = we.LAUNCHES
    if u_launches != T or u_scan != u_chunks or u_scan == 0:
        raise RuntimeError(f"user LM: {u_launches} pass1_step launches for "
                           f"{T} frames, {u_scan} scan_win for {u_chunks} "
                           "re-scan chunks")
    check_results(ures, "user_lm")
    user_same = [r.word_ids for r in ures] == [r.word_ids for r in
                                               res[side]]
    runs["user_lm"] = dict(utterances=N_SIDE, wall_s=user_wall,
                           pass1_step_launches=u_launches,
                           scan_win_launches=u_scan, rescan_chunks=u_chunks,
                           words_equal_to_forward_decode=user_same,
                           from_pass2=sum(r.from_pass == 2 for r in ures))
    entries += kernel_entries("user_lm", path_kernels(
        "user_lm", calls, {"pass1_step": u_launches, "word_end": u_we,
                           "scan_win": u_scan}, beng, card))
    del calls
    audio_s = float(lens_np.sum()) / 100.0
    phase("backward", utterances=N_UTTS, frames=T, audio_s=audio_s,
          engine_build_s=build_s, e2e_wall_s=wall, xrt=audio_s / wall,
          dnn_wall_s=dnn_s, pass1_wall_s=p1_s,
          backward_search_wall_s=search_s,
          exact_transcripts=f"{exact}/{N_UTTS}", from_pass2=from_pass2,
          pass1_step_launches=launches, scan_win_launches=scan_launches,
          cpu_decode=dict(utterances=N_SIDE, word_ids_equal=cpu_same,
                          max_score_err=cpu_err, wall_s=cpu_s),
          runs=runs, phase_s=time.perf_counter() - t_phase, card=card)
    if from_pass2 != N_UTTS or not cpu_same or cpu_err > 1e-2 \
            or not user_same or runs["cli_nrl"]["from_pass2"] != N_SIDE:
        raise RuntimeError(f"backward: {from_pass2}/{N_UTTS} from pass 2, "
                           f"CPU words equal {cpu_same} ({cpu_err}), "
                           f"user LM words equal {user_same}, {runs}")
    return entries


def full_scan_phase(eng, feats, card):
    """The full-utterance word scan: ChainCache rows of 256 flagship words
    (every sixteenth a pad), bit-equal to the device tables' rows;
    scan_words over the whole batch (W = T) and one scan_words_store
    round, each one launch of scan_win, held exactly against the plain
    version (and two chains against the numpy oracle); then the kernel
    timed at W = T beside its bound.  Returns the kernels' entries."""
    from julius_tpu_torch.ops import scan_kernel as sk
    from julius_tpu_torch.search import scan as scan_mod

    t_phase = time.perf_counter()
    rng = np.random.default_rng(17)
    V, K = eng.voca.n_words, 256
    wids = rng.integers(0, V, K)
    wids[::16] = -1
    t0 = time.perf_counter()
    rows = eng.chain_cache.rows(wids.tolist())
    rows_s = time.perf_counter() - t0
    tabs = eng.device_chains
    trow = torch.as_tensor(np.where(wids >= 0, wids, V), device=DEVICE)
    names = ("loc", "ent", "ext", "sidx")
    if not all(np.array_equal(r, getattr(tabs, n)[trow].cpu().numpy())
               for r, n in zip(rows, names)):
        raise RuntimeError("full_scan: ChainCache rows differ from "
                           "DeviceChainTables'")
    with torch.no_grad():
        out_ext = eng._outprob(feats)
    B, T, R = out_ext.shape
    N, K1 = tabs.nmax, tabs.kl + 1
    seed = (-200.0 - 100.0 * rng.random((K, T))).astype(np.float32)
    seed[rng.random((K, T)) < 0.6] = LOG_ZERO
    seed[:, 5:20] = LOG_ZERO
    bidx = rng.integers(0, B, K).astype(np.int32)
    args = [torch.from_numpy(a).to(DEVICE)
            for a in (*rows, seed, bidx)] + [out_ext]
    # one scan_words_store round: sentence starts, pad chains whose
    # out_row lies past the store, and anchors out of range
    CAP, A = K + 16, 8
    g0 = (-300.0 - 100.0 * rng.random((CAP, T))).astype(np.float32)
    g0[rng.random((CAP, T)) < 0.5] = LOG_ZERO
    b0 = rng.integers(0, T, (CAP, T)).astype(np.int32)
    parents = rng.integers(0, CAP, K).astype(np.int32)
    parents[:32] = -1
    out_rows = rng.permutation(CAP)[:K].astype(np.int32)
    out_rows[-4:] = CAP
    anchors = rng.integers(0, T, (K, A)).astype(np.int32)
    anchors[0, 0], anchors[1, 1] = T + 5, -1
    lm_adds = (-20.0 * rng.random(K)).astype(np.float32)
    sargs = [torch.from_numpy(a).to(DEVICE) for a in (
        np.where(wids >= 0, wids, V), parents, lm_adds, bidx, out_rows,
        anchors)]

    def store_round():
        gs = torch.tensor(g0, device=DEVICE)       # a fresh copy a round
        bs = torch.tensor(b0, device=DEVICE)
        return scan_mod.scan_words_store(
            gs, bs, tabs.loc, tabs.ent, tabs.ext, tabs.sidx, *sargs,
            out_ext, scan_beam=eng.search_cfg.scan_beam)

    torch.cuda.synchronize()
    sk.LAUNCHES = 0
    t0 = time.perf_counter()
    g, beg = scan_mod.scan_words(*args)
    torch.cuda.synchronize()
    words_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = store_round()
    torch.cuda.synchronize()
    store_s = time.perf_counter() - t0
    launches = sk.LAUNCHES
    if launches != 2:
        raise RuntimeError(f"full_scan: {launches} scan_win launches for "
                           "one scan_words and one scan_words_store")
    real = scan_mod.scan_core_win
    scan_mod.scan_core_win = sk.scan_core_win_plain
    try:
        t0 = time.perf_counter()
        wg, wbeg = scan_mod.scan_words(*args)
        want = store_round()
        plain_s = time.perf_counter() - t0
    finally:
        scan_mod.scan_core_win = real
    err = float((g - wg).abs().max())
    same = torch.equal(beg, wbeg) and torch.equal(got[1], want[1]) \
        and torch.equal(got[3], want[3])
    for i in (0, 2, 4):
        d = (got[i] - want[i]).abs()
        same &= bool(torch.equal(got[i].isnan(), want[i].isnan()))
        err = max(err, float(torch.nan_to_num(d, nan=0.0).max()))
    live = 0
    oracle_err = 0.0
    for k in (1, 2):
        gr, br = scan_mod.scan_words_ref(
            rows[0][k], rows[1][k], rows[2][k], rows[3][k], seed[k],
            out_ext[bidx[k]].cpu().numpy())
        fin = gr > LOG_ZERO / 2
        live += int(fin.sum())
        oracle_err = max(oracle_err, float(np.abs(
            g[k].cpu().numpy()[fin] - gr[fin]).max(initial=0.0)))
        same &= bool(np.array_equal(beg[k].cpu().numpy()[fin], br[fin]))
    targs = dict(loc=args[0], ent=args[1], ext=args[2], sidx=args[3],
                 seed=args[4], out_ext=out_ext, bidx=args[5],
                 t0=torch.zeros(K, dtype=torch.int32, device=DEVICE))
    t = time_scan(sk, targs, K, T, N, K1, n_plain=3)
    phase("full_scan", chains=K, frames=T, batch=B, nodes=N,
          arc_span_k=K1 - 1, chain_cache_rows_s=rows_s,
          scan_words_wall_s=words_s, scan_words_store_wall_s=store_s,
          plain_wall_s=plain_s, scan_win_launches=launches,
          max_abs_err=err, integers_equal=same, oracle_max_err=oracle_err,
          oracle_live_frames=live, **t, bytes=scan_bytes(K, T, N, K1),
          us_per_frame=t["ms"] * 1e3 / T,
          phase_s=time.perf_counter() - t_phase, card=card)
    if err != 0.0 or not same or oracle_err > 1e-3 or not live:
        raise RuntimeError(f"full_scan: kernel vs plain {err}, integers "
                           f"equal {same}, oracle {oracle_err}")
    return kernel_entries("full_scan", {"scan_win": dict(
        launches=launches, max_abs_err=err, **t)})


#: every sharded_graph line of the run, for the summary
SHARDED_LINES = []


def sharded_vs_eager(label, S, snet, eng, out_ext, n_frames, captures,
                     card):
    """sharded_pass1 of one utterance on a mesh that repeats the card S
    times, three ways: its first call (which captures the key's graph
    unless an earlier call did: `captures` is what it must take), again
    from the cached graph (replays counted by wrapping
    CUDAGraph.replay), and its eager oracle (eager=True: the same step
    once a frame from Python).  The three trellises must be bit-equal in
    all six fields, the second call must capture nothing and replay the
    graph once a frame.  Prints a sharded_graph line (ms a frame of each
    call, replays a frame, captures and their seconds) and returns its
    fields and the cached call's trellis."""
    from julius_tpu_torch.parallel import mesh as pm
    from julius_tpu_torch.parallel import sharded_pass1 as sp

    mesh = pm.make_mesh(devices=[DEVICE] * S, tp=S)
    T = out_ext.shape[0]

    def counts():
        cache = snet.caches.graphs.get(mesh.devices[0][0])
        return (cache.captures, cache.capture_s) if cache else (0, 0.0)

    def run(**kw):
        return sp.sharded_pass1(mesh, snet, eng.ngram_dev, eng.p1_cfg,
                                out_ext, n_frames, **kw)

    c0 = counts()
    first, first_s = timed(run)
    c1 = counts()
    replays, real = [0], torch.cuda.CUDAGraph.replay

    def replay(self):
        replays[0] += 1
        return real(self)

    torch.cuda.CUDAGraph.replay = replay
    try:
        graphed, graphed_s = timed(run)
    finally:
        torch.cuda.CUDAGraph.replay = real
    c2 = counts()
    eager, eager_s = timed(lambda: run(eager=True))
    fields = dict(
        path=label, shards=S, frames=T, n_frames=int(n_frames),
        cards=len(set(mesh.devices[0])),
        bit_equal=same_tensors(graphed, eager) and same_tensors(first, eager),
        graph_replays=replays[0], graph_replays_per_frame=replays[0] / T,
        first_call_ms_per_frame=first_s * 1e3 / T,
        graphed_ms_per_frame=graphed_s * 1e3 / T,
        eager_ms_per_frame=eager_s * 1e3 / T,
        eager_over_graphed=eager_s / graphed_s,
        captures_first_call=c1[0] - c0[0], capture_s=c1[1] - c0[1],
        captures_second_call=c2[0] - c1[0])
    phase("sharded_graph", **fields, card=card)
    SHARDED_LINES.append(fields)
    if not fields["bit_equal"] or replays[0] != T \
            or fields["captures_first_call"] != captures \
            or fields["captures_second_call"]:
        raise RuntimeError(f"{label}: the graphed sharded pass 1 differs "
                           f"from its eager oracle, or captured other than "
                           f"once: {fields}")
    return fields, graphed


def parallel_phase(eng, feats, lens_np, truths, card):
    """parallel/ on the one card, as meshes that repeat it: sharded_pass1
    with S = 1, 2 and 4 on one flagship utterance, graphed against its
    eager oracle (sharded_vs_eager: a sharded_graph line each, and one
    more at S = 2 with the utterance padded past n_frames by 32 frames
    of the next, in the S = 2 graph's frame bucket), against one shard (the same trellis) and the
    single-device unfused pass 1 (the same words); parallel_decode_fn
    with dp = 2 on 16 waveforms against the engine's own front end, DNN
    and unfused pass 1 (the same trellis); the DNN split over tp = 2 by
    shard_engine against the unsplit DNN (within the bf16 rule's atol
    2e-2).  Every path here runs pass 1's unfused step, as the
    reference's does, so pass1_step is launched no time."""
    from julius_tpu_torch.ops import pass1_kernel as pk
    from julius_tpu_torch.parallel import mesh as pm
    from julius_tpu_torch.parallel import sharded_pass1 as sp
    from julius_tpu_torch.search import pass1 as p1

    t_phase = time.perf_counter()
    n0, n1 = int(lens_np[0]), int(lens_np[1])
    with torch.no_grad():
        out2 = eng._outprob(feats[:2])
    out1 = out2[0, :n0]
    # the utterance padded past n_frames with 32 real frames (the next
    # utterance's); in the S = 2 graph's frame bucket, it captures none
    padded = torch.cat([out1, out2[1, :min(32, n1)]])
    bucket = [max(p1.MIN_T_BUCKET, 1 << (t - 1).bit_length())
              for t in (n0, padded.shape[0])]
    pk.LAUNCHES = 0
    single = p1.pass1_batch(eng.dev_net, eng.ngram_dev, eng.p1_cfg,
                            out1[None], torch.tensor([n0]), use_kernel=False)
    single = p1.Trellis(*[a[0] for a in single])

    def words(tr):
        r = p1.backtrace(p1.Trellis(*[a.cpu().numpy() for a in tr]), n0,
                         eng.net.tail_word)
        return [eng.voca.names[w] for w in r["words"]] if r else None

    sharded, snets, ref = {}, {}, None
    for S in (1, 2, 4):
        snets[S] = sp.partition_network(eng.net, eng.dev_net, S)
        line, tr = sharded_vs_eager("parallel", S, snets[S], eng, out1, n0,
                                    1, card)
        if ref is None:
            ref = tr
        sharded[S] = dict(
            ms_per_frame=line["first_call_ms_per_frame"],
            graphed_ms_per_frame=line["graphed_ms_per_frame"],
            eager_ms_per_frame=line["eager_ms_per_frame"],
            equal_to_one_shard=all(torch.equal(a, b)
                                   for a, b in zip(tr, ref)),
            frames_differing_from_single_device=int(
                (tr.word != single.word).any(dim=1).sum()),
            words_equal_truth=words(tr) == truths[0])
    line, tr = sharded_vs_eager("parallel_padded", 2, snets[2], eng, padded,
                                n0, int(bucket[0] != bucket[1]), card)
    padded_same = same_tensors([a[:n0] for a in tr], ref) \
        and bool((tr.word[n0:] == -1).all())
    single_words = words(single)

    # dp = 2: 16 waveforms of 3 s split over two rows of the card
    rng = np.random.default_rng(5)
    wave = (rng.standard_normal((N_UTTS, 48000)) * 2000).astype(np.float32)
    lengths = np.full(N_UTTS, 48000, np.int32)
    lengths[1::3] = 40000
    fn = pm.parallel_decode_fn(eng, pm.make_mesh(devices=[DEVICE] * 2,
                                                 tp=1))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr, nfr = fn(wave, lengths)
    torch.cuda.synchronize()
    dp_s = time.perf_counter() - t0
    with torch.no_grad():
        fw, mask = eng._features(torch.from_numpy(wave).to(DEVICE),
                                 torch.from_numpy(lengths).to(DEVICE))
        n = mask.to(torch.int32).sum(dim=-1)
        own = p1.pass1_batch(eng.dev_net, eng.ngram_dev, eng.p1_cfg,
                             eng._outprob(fw), n, use_kernel=False)
    dp_same = torch.equal(nfr, n) and all(torch.equal(a, b)
                                          for a, b in zip(tr, own))

    # tp = 2: the DNN split over a 1 x 2 mesh of the card
    pm.shard_engine(eng, pm.make_mesh(devices=[DEVICE] * 2, tp=2))
    rep = eng.mesh_replicas[0]
    with torch.no_grad():
        split = rep._outprob(feats[:N_SIDE])
        whole = eng._outprob(feats[:N_SIDE])
    tp_err = float((split - whole).abs().max())
    n_layers = len(eng.dnn_scorer.weights)
    budget = (n_layers + 1 + 1) // 2 + 1
    collectives = rep.dnn_scorer.collectives
    launches = pk.LAUNCHES
    phase("parallel", device_count=torch.cuda.device_count(),
          sharded=sharded, utterance_frames=n0,
          padded=dict(frames=int(padded.shape[0]),
                      equal_to_unpadded=padded_same),
          single_device_words_equal_truth=single_words == truths[0],
          dp2=dict(utterances=N_UTTS, frames=int(tr.word.shape[1]),
                   wall_s=dp_s, trellis_equal_to_engine=dp_same),
          tp2=dict(dnn_max_err=tp_err, collectives=collectives,
                   collective_budget=budget, hidden_layers=n_layers),
          pass1_step_launches=launches,
          phase_s=time.perf_counter() - t_phase, card=card)
    if not all(v["equal_to_one_shard"] and v["words_equal_truth"]
               for v in sharded.values()) or not padded_same \
            or single_words != truths[0] or not dp_same \
            or tp_err > 2e-2 or collectives > budget or launches:
        raise RuntimeError(f"parallel: sharded {sharded}, padded "
                           f"{padded_same}, dp2 {dp_same}, "
                           f"tp2 {tp_err} / {collectives}, "
                           f"{launches} pass1_step launches")


#: the flagship's published widths, as the reference-binary tools export them
REF_SIZE = dict(n_words=5000, n_phones=668, hidden=2048, n_layers=5)


def refexport_phase(card):
    """The reference-binary tools' exports at flagship scale into a
    temporary directory: refbaseline.export_model (binhmm, dictionary,
    ARPA, dnnconf, npy) and refparity.export_flagship (ascii hmmdefs with
    SIDs, dictionary, ARPA, dnn.conf, npy), each read back through the
    port's readers against the in-memory model (binary tables bit-equal,
    text at their printed digits); then 4 generative utterances written
    as the spliced feature files the reference reads are decoded by the
    port's command line from the exported files (-input mfcfile) against
    the truths the export knows.  No reference binary is run.  Returns
    the kernels' entries."""
    import os

    from julius_tpu_torch.io.arpa import load_arpa
    from julius_tpu_torch.io.binhmm import read_binhmm
    from julius_tpu_torch.io.dnn import load_dnn, parse_dnnconf
    from julius_tpu_torch.io.htk_dict import load_htkdict
    from julius_tpu_torch.io.htk_hmm import load_hmmdefs
    from julius_tpu_torch.io.htk_param import HTKParam, write_htk_param
    from julius_tpu_torch.ops import pass1_kernel as pk
    from julius_tpu_torch.ops import scan_kernel as sk
    from julius_tpu_torch.ops import word_end_kernel as we
    from julius_tpu_torch.search import pass2_device as p2d
    from julius_tpu_torch.search import pass2_rescan as p2r
    from julius_tpu_torch.search import scan as scan_mod
    from julius_tpu_torch.tools import recognize, refbaseline, refparity
    from julius_tpu_torch.tools.synth import (make_dnn, make_flagship_utts,
                                              make_hmmset, make_ngram,
                                              make_vocabulary)

    def at_digits(read, value, digits):
        return float(np.max(np.abs(np.asarray(read, np.float64)
                                   - np.asarray(value, np.float64)),
                            initial=0.0)) <= 0.5 * 10.0 ** -digits + 1e-6

    walls, checks = {}, {}
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ref_")
    try:
        base = os.path.join(tmp, "base")
        os.mkdir(base)
        t0 = time.perf_counter()
        paths = refbaseline.export_model(base, **REF_SIZE)
        walls["export_model_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        hmm = make_hmmset(n_phones=REF_SIZE["n_phones"], dim=120, seed=0)
        voca = make_vocabulary(hmm, n_words=REF_SIZE["n_words"], seed=1)
        lm = make_ngram(voca, seed=2)
        dnn = make_dnn(dim_in=1320, hidden=REF_SIZE["hidden"],
                       n_layers=REF_SIZE["n_layers"], n_out=hmm.n_states,
                       seed=3)
        rhmm, para = read_binhmm(paths["hmm"])
        checks["binhmm_bit_equal"] = all(
            np.array_equal(getattr(rhmm, f), getattr(hmm, f))
            for f in ("means", "ivars", "gconst", "state_mix", "state_lw",
                      "phone_states", "phone_ns", "phone_trans"))
        rvoca = load_htkdict(paths["dict"])
        checks["dict_equal"] = (rvoca.names == voca.names
                                and rvoca.phones == voca.phones)
        rlm = load_arpa(paths["lm"])
        checks["arpa_at_6_digits"] = all(
            set(rlm.ngrams[k]) == set(lm.ngrams[k]) and at_digits(
                [rlm.ngrams[k][t] for t in lm.ngrams[k]],
                list(lm.ngrams[k].values()), 6) for k in (0, 1))
        rdnn = load_dnn(parse_dnnconf(paths["dnnconf"]), base)
        # the reader turns a layer back to [in][out] only when it is not
        # square: a square hidden layer comes back transposed, as the
        # reference's reader reads it
        checks["npy_bit_equal"] = all(
            np.array_equal(a, b.T if b.shape[0] == b.shape[1] else b)
            for a, b in zip(rdnn.weights + [rdnn.output_w],
                            dnn.weights + [dnn.output_w])) and all(
            np.array_equal(a, b) for a, b in zip(
                rdnn.biases + [rdnn.output_b], dnn.biases + [dnn.output_b]))
        # the prior is printed with 9 significant digits
        checks["prior_log10_within_1e-6"] = bool(np.allclose(
            rdnn.log_prior, dnn.log_prior, rtol=0, atol=1e-6))
        walls["read_back_s"] = time.perf_counter() - t0

        par = os.path.join(tmp, "parity")
        t0 = time.perf_counter()
        hmm2, voca2, lm2, dnn2, protos = refparity.export_flagship(
            par, dim=120, context=11, **REF_SIZE)
        walls["export_flagship_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rh = load_hmmdefs(os.path.join(par, "hmmdefs"))
        # each read state's Gaussian against its <SID>'s in memory
        rg = rh.state_mix[:, 0]
        g = hmm2.state_mix[rh.state_sid, 0]
        checks["hmmdefs_at_4_digits"] = (
            sorted(rh.state_sid.tolist()) == list(range(hmm2.n_states))
            and at_digits(rh.means[rg], hmm2.means[g], 4)
            and at_digits(1.0 / rh.ivars[rg], 1.0 / hmm2.ivars[g], 4))
        rlm2 = load_arpa(os.path.join(par, "lm.arpa"))
        checks["lm_arpa_at_4_digits"] = all(
            set(rlm2.ngrams[k]) == set(lm2.ngrams[k]) and at_digits(
                [rlm2.ngrams[k][t][0] for t in lm2.ngrams[k]],
                [v[0] for v in lm2.ngrams[k].values()], 4) for k in (0, 1))
        rdnn2 = load_dnn(parse_dnnconf(os.path.join(par, "dnn.conf")), par)
        checks["dnn_conf_npy_bit_equal"] = all(
            np.array_equal(a, b.T if b.shape[0] == b.shape[1] else b)
            for a, b in zip(rdnn2.weights + [rdnn2.output_w],
                            dnn2.weights + [dnn2.output_w]))
        walls["read_back_flagship_s"] = time.perf_counter() - t0

        truths, wins, _ = make_flagship_utts(
            hmm2, voca2, lm2, protos, N_SIDE, 120, 11, min_words=6,
            max_words=12, seed=9)
        inputs = []
        for u, w in enumerate(wins):
            inputs.append(os.path.join(par, f"utt{u:03d}.mfc"))
            write_htk_param(inputs[-1], HTKParam(data=w, samp_period=100000,
                                                 kind="USER"))
        lmp = ["8.0", "-2.0"]
        argv = ["-h", os.path.join(par, "hmmdefs"),
                "-v", os.path.join(par, "words.dict"),
                "-nlr", os.path.join(par, "lm.arpa"),
                "-dnnconf", os.path.join(par, "dnn.conf"),
                "-input", "mfcfile", "-lmp", *lmp, "-lmp2", *lmp, "-b", "0",
                "-batchsize", str(N_SIDE)] + inputs
        results = []
        with recorded_calls(pk, sk, p2d, scan_mod) as calls:
            pk.LAUNCHES = sk.LAUNCHES = we.LAUNCHES = p2r.CHUNKS = 0
            p2d.LAST_STATS.clear()
            lines, wall, built = run_cli(recognize, argv, results)
            launches, scan_launches = pk.LAUNCHES, sk.LAUNCHES
            we_launches = we.LAUNCHES
        walls["cli_s"] = wall
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check_results(results, "refexport_cli")
    got = [ln.split(": ", 1)[1] if ": " in ln else ""
           for ln in lines if ln.startswith("sentence1:")]
    want = [" ".join(w for w in t if w not in ("<s>", "</s>"))
            for t in truths]
    exact = sum(a == b for a, b in zip(got, want))
    entries = kernel_entries("refexport_cli", path_kernels(
        "refexport_cli", calls, {"pass1_step": launches,
                                 "word_end": we_launches,
                                 "scan_win": scan_launches}, built[0], card))
    phase("refexport", walls=walls, checks=checks, files=N_SIDE,
          exact_transcripts=f"{exact}/{N_SIDE}",
          from_pass2=sum(r.from_pass == 2 for r in results),
          pass1_step_launches=launches, scan_win_launches=scan_launches,
          phase_s=time.perf_counter() - t_phase, card=card)
    if not all(checks.values()) or len(got) != N_SIDE:
        raise RuntimeError(f"refexport: {checks}, {len(got)} sentences")
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from julius_tpu_torch.ops import cuda_build
    from julius_tpu_torch.ops import pass1_kernel as pk
    from julius_tpu_torch.ops import pseudo_kernel as psk
    from julius_tpu_torch.ops import scan_kernel as sk
    from julius_tpu_torch.ops import suffix_kernel as sx
    from julius_tpu_torch.ops import word_end_kernel as we
    from julius_tpu_torch.search import pass1 as p1
    from julius_tpu_torch.search import pass2 as p2
    from julius_tpu_torch.search import pass2_device as p2d
    from julius_tpu_torch.search import pass2_rescan as p2r
    from julius_tpu_torch.ops.dnn import build_dnn_scorer, dnn_scores
    from julius_tpu_torch.tools.synth import (flagship_engine,
                                              make_flagship_utts)

    name = torch.cuda.get_device_name(0)
    card = card_line()
    phase("device", name=name, nvidia_smi=card, torch=torch.__version__,
          cuda=torch.version.cuda)

    from julius_tpu_torch.tools.time_word_end import PHASES_FLAG

    t0 = time.perf_counter()
    # the three kernels and word_end's phase-stamp build, one nvcc each
    cuda_build.compile_all([pk.SOURCE, sk.SOURCE, we.SOURCE, sx.SOURCE,
                            psk.SOURCE, (we.SOURCE, (PHASES_FLAG,))])
    for m in (pk, sk, we, sx, psk):
        m.build()
    build_s = time.perf_counter() - t0
    ptxas = {m.SOURCE.name: cuda_build.ptxas_report(m.SOURCE)
             for m in (pk, sk, we, sx, psk)}
    ptxas[f"{we.SOURCE.name} {PHASES_FLAG}"] = cuda_build.ptxas_report(
        we.SOURCE, (PHASES_FLAG,))
    phase("build", seconds=round(build_s, 3),
          kernels=["pass1_step", "scan_win", "word_end", "suffix", "pseudo"],
          ptxas=ptxas)
    for source, report in ptxas.items():
        check_no_spills(report, source)

    t0 = time.perf_counter()
    eng, protos = flagship_engine(trained=True, device=DEVICE)
    dev = eng.dev_net
    N, K1 = dev.loc_lp.shape[1], dev.loc_lp.shape[0]
    R = int(eng._state_sid.shape[0])
    etot = p1.entry_total(dev)
    phase("engine", seconds=round(time.perf_counter() - t0, 3),
          nodes=N, arc_span_k=K1 - 1, senones=R,
          exits=int(dev.exit_nodes.shape[0]), words=eng.voca.n_words,
          trellis_m=eng.p1_cfg.n_atoms)

    # ---- kernel vs plain at the main path's shapes and the batch sizes
    # the other paths give it (4: cli_lattice, 2: cli_gshmm, 1: cli_48)
    max_err = 0.0
    for B in STEP_BATCHES:
        for ties in (True, False):
            for padded in (True, False):
                args = step_inputs(dev, etot, B, R, seed=B + ties,
                                   ties=ties, padded=padded)
                err, _ = compare_step(pk, args)
                max_err = max(max_err, err)
    # a run of frames, each fed the previous frame's output
    args = step_inputs(dev, etot, 64, R, seed=7, ties=False)
    for f in range(6):
        err, out = compare_step(pk, args)
        max_err = max(max_err, err)
        args = dict(args, score=out[0], ctx=out[1], prev=out[2],
                    row=args["row"].roll(f + 1, dims=1),
                    frame_valid=args["frame_valid"].roll(1))
    Np = p1.kernel_tables(dev)[0].shape[1]
    phase("kernel_check", kernel="pass1_step", max_abs_err=max_err,
          shapes=[[B, n, K1 - 1] for B in STEP_BATCHES for n in (Np, N)])

    # each shape timed three ways (step_ways), beside one empty launch of
    # the same library timed as (a): the floor of a launch
    from julius_tpu_torch.utils.cuda_timing import l2_flush, time_ms
    flush = l2_flush(DEVICE)
    floor_ms = time_ms(pk.empty_launch)
    phase("launch_floor", kernel="empty", ms=floor_ms, card=card)
    # at the main path's shape: the node axis padded as pass1_batch pads
    timings = {}
    for B in STEP_BATCHES:
        args = step_inputs(dev, etot, B, R, seed=11, ties=False, padded=True)
        timings[B] = t = time_step(pk, args, B, Np, K1, R)
        ways = step_ways(pk, args, flush)
        nbytes = step_bytes(B, Np, K1, R)
        phase("kernel_time", kernel="pass1_step", batch=B, nodes=Np, **t,
              **ways, cold_share_of_bound=t["bound_ms"] / ways["cold_ms"],
              bytes=nbytes, gb_per_s=nbytes / t["ms"] / 1e6,
              share_of_hbm=nbytes / (t["ms"] * 1e-3) / HBM_BYTES_PER_S,
              launch_floor_ms=floor_ms,
              plan=pk._plan(args["score"].device, B, Np, K1)._asdict(),
              library_ms=None, card=card)
    del flush

    # ---- scan_win vs plain: the device A*'s shape, two window buckets of
    # the host re-scan, then the kernel's edges: one frame, a chunk less
    # and more one frame, the whole utterance, and chains of more than 32
    # nodes (the block template) on synthetic tables
    tabs = eng.device_chains
    wide = synthetic_chains(500, 45, 2, R, seed=5)
    T_A, B_A = 509, N_UTTS
    K_A, W_A = B_A * p2d.POPS, p2d.SCAN_WIN
    C = sk.CHUNK
    scan_shapes = [(tabs, K_A, W_A), (tabs, 256, 64), (tabs, 1024, 256),
                   (tabs, K_A, 1), (tabs, K_A, C - 1), (tabs, K_A, C + 1),
                   (tabs, K_A, T_A), (wide, 64, 100)]
    scan_err = 0.0
    for tb, K, W in scan_shapes:
        for ties in (True, False):
            args = scan_inputs(tb, K, W, T_A, R, B_A, K + W + ties, ties)
            scan_err = max(scan_err, compare_scan(sk, args))
    phase("kernel_check", kernel="scan_win", max_abs_err=scan_err,
          shapes=[[K, W, tb.nmax, tb.kl] for tb, K, W in scan_shapes],
          frames=T_A, senones=R)
    scan_t = {}
    for n_shape, (tb, K, W) in enumerate(scan_shapes):
        N_c, K1_c = tb.nmax, tb.kl + 1
        args = scan_inputs(tb, K, W, T_A, R, B_A, 3, False)
        # the plain version at the edges: a few calls are enough
        scan_t[N_c, K, W] = t = time_scan(sk, args, K, W, N_c, K1_c,
                                          n_plain=50 if n_shape < 3 else 10)
        phase("kernel_time", kernel="scan_win", chains=K, window=W,
              nodes=N_c, arc_span_k=K1_c - 1, **t,
              bytes=scan_bytes(K, W, N_c, K1_c),
              us_per_frame=t["ms"] * 1e3 / W, library_ms=None, card=card)

    # ---- the full-width slice through the engine's entry point
    truths, wins, lens = make_flagship_utts(
        eng.hmm, eng.voca, eng.lm, protos, N_UTTS, 120, 11,
        min_words=6, max_words=12, seed=1)
    feats, lens_np = pad_windows(wins, lens)
    T = feats.shape[1]

    # DNN scores on the card against the CPU path on a small input
    x = feats[:2, :200]
    on_card = eng._outprob(x).cpu()
    cpu_scorer = build_dnn_scorer(eng.dnn_params, "cpu")
    on_cpu = dnn_scores(cpu_scorer, x.cpu())[..., eng._state_sid.cpu()]
    dnn_err = float((on_card - on_cpu).abs().max())
    agree = float((on_card.argmax(-1) == on_cpu.argmax(-1)).float().mean())
    if not (dnn_err <= 2e-2 and agree >= 0.99):
        raise RuntimeError(f"DNN on card vs CPU: max err {dnn_err}, "
                           f"argmax agreement {agree}")

    if not (eng.search_cfg.pass2_rescan and eng._device_astar_ok()):
        raise RuntimeError("flagship_engine does not take the device A*")
    eng.decode_features(feats[:2], lens_np[:2])     # warm-up
    torch.cuda.synchronize()
    pk.LAUNCHES = sk.LAUNCHES = we.LAUNCHES = sx.LAUNCHES = 0
    p2r.CHUNKS = 0
    t0 = time.perf_counter()
    res, spans = traced(eng.decode_features, feats, lens_np)
    e2e_s = time.perf_counter() - t0
    launches, we_launches = pk.LAUNCHES, we.LAUNCHES
    scan_launches, chunks = sk.LAUNCHES, p2r.CHUNKS
    stats = dict(p2d.LAST_STATS)
    net = dict(eng.last_pass2)
    if launches != T or we_launches != T:
        raise RuntimeError(f"{launches} pass1_step and {we_launches} "
                           f"word_end launches for {T} frames")
    if sx.LAUNCHES != 1:
        raise RuntimeError(f"{sx.LAUNCHES} suffix launches for one batch")
    if scan_launches != stats["replayed"] + chunks or scan_launches == 0:
        raise RuntimeError(f"{scan_launches} scan_win launches for "
                           f"{stats['replayed']} A* rounds run + {chunks} "
                           "chunks")

    # the same decode again in its three stages, for where the time goes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        out_ext = eng._outprob(feats)
    torch.cuda.synchronize()
    dnn_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tr_kernel = eng._pass1(out_ext, lens_np)
    torch.cuda.synchronize()
    p1_s = time.perf_counter() - t0
    with torch.no_grad(), counted_astar(p2d) as staged_astar:
        t0 = time.perf_counter()
        staged = eng._results(tr_kernel, lens_np, out_ext=out_ext)
        p2_s = time.perf_counter() - t0
    staged_net = dict(eng.last_pass2)
    staged_s = sum(astar_wall(c["stats"]["spans"])
                   for c in staged_astar["calls"])
    if [r.word_ids for r in staged] != [r.word_ids for r in res]:
        raise RuntimeError("staged decode differs from decode_features")
    states = {}
    slice_graph = graph_vs_eager("slice", eng.dev_net, eng.ngram_dev,
                                 eng.p1_cfg, out_ext, lens_np,
                                 got=tr_kernel, card=card,
                                 record=lambda: recorded_word_end(states))
    slice_word_end = word_end_path("slice", states.pop("word_end"),
                                   we_launches, card, phases=True)
    slice_astar = astar_vs_eager("slice", staged_astar, card)
    suffix_path("slice", staged_astar, card)
    # B = 1, as the reference decodes and flagship.utt1 runs
    with torch.no_grad(), counted_astar(p2d) as one_astar:
        eng.decode_features(feats[:1], lens_np[:1])
    suffix_path("slice_b1", one_astar, card)
    stop_every_sweep("slice", staged_astar["calls"][0], card)
    astar_profile("slice", staged_astar["calls"][0], card)
    capture_cost("slice", staged_astar["calls"][0], card)
    # the eager loop with the kernel's plain version in it
    real = pk.fused_step
    pk.fused_step = pk.fused_step_plain
    try:
        t0 = time.perf_counter()
        tr_plain = p1.pass1_batch(eng.dev_net, eng.ngram_dev, eng.p1_cfg,
                                  out_ext, torch.as_tensor(lens_np),
                                  eager=True)
        torch.cuda.synchronize()
        p1_plain_s = time.perf_counter() - t0
    finally:
        pk.fused_step = real
    launch_guard(out_ext.device, card)
    frame_profile("slice", eng, out_ext, lens_np, card)
    valid = tr_plain.word >= 0
    for f in tr_kernel._fields:
        a, b = getattr(tr_kernel, f), getattr(tr_plain, f)
        if a.shape != (N_UTTS, T, eng.p1_cfg.n_atoms):
            raise RuntimeError(f"trellis {f} has shape {tuple(a.shape)}")
        if a.dtype.is_floating_point:
            if not torch.isfinite(a).all():
                raise RuntimeError(f"trellis {f} is not finite")
            d = float(torch.where(valid, (a - b).abs(), 0.0).max())
            if d > 1e-5:
                raise RuntimeError(f"kernel vs plain trellis {f}: {d}")
        elif not torch.equal(torch.where(valid, a, 0),
                             torch.where(valid, b, 0)):
            raise RuntimeError(f"kernel vs plain trellis {f} differ")
    if not torch.equal(tr_kernel.word, tr_plain.word):
        raise RuntimeError("kernel vs plain trellis words differ")

    # the device A* again on the same lattices and outprobs, kernel path
    # then plain path
    host = p1.Trellis(*[a.cpu().numpy() for a in tr_kernel])
    lats = [p2.TrellisLattice(p1.Trellis(*[a[b] for a in host]), int(n))
            for b, n in enumerate(lens_np)]
    astar_args = (lats, eng.device_chains, eng.ngram_dev, eng._wid2lm,
                  eng._cprob_arr(), out_ext, eng._rescan_strategy(),
                  eng.search_cfg)
    with torch.no_grad():
        t0 = time.perf_counter()
        nb_kernel = p2d.run_batch(*astar_args, best_in=eng._p2d_best_in)
        rerun_s = time.perf_counter() - t0
        p2d.scan_core_win = sk.scan_core_win_plain
        try:
            t0 = time.perf_counter()
            nb_plain = p2d.run_batch(*astar_args, best_in=eng._p2d_best_in,
                                     eager=True)
            astar_plain_s = time.perf_counter() - t0
        finally:
            p2d.scan_core_win = sk.scan_core_win
    for a, b in zip(nb_kernel, nb_plain):
        if [r.word_ids for r in a] != [r.word_ids for r in b] or any(
                abs(x.score - y.score) > 1e-4 for x, y in zip(a, b)):
            raise RuntimeError("device A* kernel vs plain scan differ")

    check_results(res, "flagship")
    exact = exact_count(res, truths)
    audio_s = float(lens_np.sum()) / 100.0
    phase("slice", utterances=N_UTTS, frames=T, audio_s=audio_s,
          dnn_wall_s=dnn_s, pass1_wall_s=p1_s,
          pass2_and_results_wall_s=p2_s,
          astar_wall_s=staged_s,
          retry_net_wall_s=staged_net["retry_s"],
          assembly_wall_s=p2_s - staged_s - staged_net["retry_s"],
          **astar_split(slice_astar),
          astar_rerun_wall_s=rerun_s, astar_plain_scan_wall_s=astar_plain_s,
          pass1_plain_wall_s=p1_plain_s,
          pass1_eager_wall_s=slice_graph["eager_wall_s"],
          pass1_graphs=eng.dev_net.graphs.captures,
          pass1_capture_s=eng.dev_net.graphs.capture_s,
          pass1_kernel_s=launches * timings[N_UTTS]["ms"] * 1e-3,
          e2e_wall_s=e2e_s, xrt=audio_s / e2e_s,
          exact_transcripts=f"{exact}/{N_UTTS}",
          from_pass2=sum(r.from_pass == 2 for r in res),
          retried=net["retried"], astar_rounds=stats["rounds"],
          astar_replayed=stats["replayed"], astar_waits=stats["waits"],
          astar_captured=stats["captured"],
          astar_n_pops=stats["n_pops"],
          astar_loop_wall_s=spans["astar.rounds"].total_s,
          max_rounds=stats["max_rounds"], CAPP=stats["CAPP"],
          kernel_launches=launches, word_end_launches=we_launches,
          scan_win_launches=scan_launches, rescan_chunks=chunks,
          suffix_launches=1,
          dnn_card_vs_cpu_max_err=dnn_err, card=card)
    if exact < N_UTTS - 1:
        raise RuntimeError(f"only {exact}/{N_UTTS} exact transcripts")

    # ---- the host re-scan (ScanDispatcher at its window buckets)
    side = slice(0, N_SIDE)
    base_cfg = eng.search_cfg
    eng.search_cfg = dataclasses.replace(base_cfg, pass2_device=False)
    sk.LAUNCHES = p2r.CHUNKS = 0
    try:
        t0 = time.perf_counter()
        res_rescan = eng.decode_features(feats[side], lens_np[side])
        rescan_s = time.perf_counter() - t0
    finally:
        eng.search_cfg = base_cfg
    if [r.word_ids for r in res_rescan] != [r.word_ids for r in res[side]]:
        raise RuntimeError("host re-scan and device A* word ids differ")
    if sk.LAUNCHES != p2r.CHUNKS or p2r.CHUNKS == 0:
        raise RuntimeError(f"{sk.LAUNCHES} scan_win launches for "
                           f"{p2r.CHUNKS} re-scan chunks")
    phase("rescan", utterances=N_SIDE, wall_s=rescan_s,
          scan_win_launches=sk.LAUNCHES, chunks=p2r.CHUNKS,
          from_pass2=sum(r.from_pass == 2 for r in res_rescan), card=card)

    # ---- the frozen-score pass 2 of the first slice
    eng.search_cfg = dataclasses.replace(base_cfg, pass2_rescan=False)
    try:
        t0 = time.perf_counter()
        res_frozen = eng.decode_features(feats[side], lens_np[side])
        frozen_s = time.perf_counter() - t0
    finally:
        eng.search_cfg = base_cfg
    for r in res_frozen:
        if not (r.valid and np.isfinite(r.score) and r.words):
            raise RuntimeError(f"bad frozen-search result {r}")
    frozen_exact = exact_count(res_frozen, truths[side])
    phase("frozen", utterances=N_SIDE, wall_s=frozen_s,
          exact_transcripts=f"{frozen_exact}/{N_SIDE}",
          from_pass2=sum(r.from_pass == 2 for r in res_frozen), card=card)

    kernels = waveform_phase(eng, card, dict(timings[64],
                                             max_abs_err=max_err))
    kernels += lvcsr_phase(card)
    task_dir = tempfile.mkdtemp(prefix="chip_smoke_task_")
    try:
        entries, task_files = cli_phase(card, task_dir)
        kernels += entries
        # the grammar slice's paths after the earlier ones, so that those
        # run in the same process state as before and compare with older
        # runs; then the alignment and streaming slice's
        kernels += grammar_phase(eng, protos, card)
        isolated_phase(eng, protos, card)
        kernels += unfused_ngram_phase(eng, feats, lens_np, truths, card)
        gather_phase(card)
        kernels += align_phase(eng, protos, card)
        entries, stream_in = stream_phase(eng, card)
        kernels += entries
        live = live_inputs(task_dir, task_files)
        stream_vad_phase(eng, card, task_files, live)
        kernels += cli_live_phase(card, task_files, live)
        # the server slice's paths, last, so that the earlier phases run
        # as in older versions of the script
        kernels += server_phase(eng, card, stream_in, live)
        kernels += vecnet_phase(eng, card, feats, lens_np, truths, res)
        kernels += server_grammar_phase(card, task_files)
        kernels += tools_phase(eng, card, task_files)
        # the last modules' paths, after every earlier phase
        kernels += backward_phase(eng, feats, lens_np, truths, res, card,
                                  task_files)
        kernels += full_scan_phase(eng, feats, card)
        parallel_phase(eng, feats, lens_np, truths, card)
        kernels += refexport_phase(card)
    finally:
        shutil.rmtree(task_dir, ignore_errors=True)

    flagship = kernel_entries("flagship", {
        "pass1_step": dict(timings[N_UTTS], launches=launches,
                           max_abs_err=max_err),
        "scan_win": dict(scan_t[tabs.nmax, K_A, W_A], launches=scan_launches,
                         max_abs_err=scan_err),
        "word_end": slice_word_end})
    phase("pass1_graph_summary", note="pass 1 a frame, graphed (replays "
          "of the captured step) beside its eager oracle on the same batch",
          paths=[{k: g[k] for k in (
              "path", "batch", "frames", "fused", "graphed_ms_per_frame",
              "eager_ms_per_frame", "eager_over_graphed",
              "network_graphs", "network_capture_s")} for g in GRAPH_LINES],
          card=card)
    phase("astar_graph_summary", note="the device A* per path, graphed "
          "(replays of the captured round) beside its eager oracle on the "
          "same inputs; walls summed over the path's calls",
          paths=[{k: g[k] for k in (
              "path", "calls", "rounds", "replayed", "waits", "captures",
              "capture_s", "graphed_loop_s", "eager_loop_s",
              "eager_over_graphed", "prepare_s", "readback_s")}
              for g in ASTAR_LINES], card=card)
    phase("stream_graph_summary", note="a stream's pass-1 chunk per path, "
          "graphed (one replay a chunk row) beside its eager oracle on the "
          "same inputs", paths=[{k: g[k] for k in (
              "path", "chunks", "rows", "graph_launches_per_row", "captures",
              "capture_s", "graphed_ms_per_block", "eager_ms_per_block",
              "graphed_ms_per_frame", "eager_ms_per_frame",
              "eager_over_graphed")} for g in STREAM_LINES], card=card)
    phase("align_graph_summary", note="the alignment Viterbi per path, "
          "graphed (one replay a frame, a graph a bucket of chain sizes) "
          "beside its eager oracle on the same inputs",
          paths=[{k: g[k] for k in (
              "path", "utterances", "frames", "buckets", "captures",
              "capture_s", "graphed_ms_per_utterance",
              "eager_ms_per_utterance", "eager_over_graphed",
              "wall_split_ms_per_utterance")} for g in ALIGN_LINES],
          card=card)
    phase("sharded_graph_summary", note="the sharded pass 1 a frame on "
          "meshes that repeat the card, graphed (one replay a frame of the "
          "one-card step) beside its eager oracle on the same utterance",
          paths=[{k: g[k] for k in (
              "path", "shards", "frames", "n_frames",
              "graph_replays_per_frame", "captures_first_call", "capture_s",
              "graphed_ms_per_frame", "eager_ms_per_frame",
              "eager_over_graphed")}
              for g in SHARDED_LINES], card=card)
    print(json.dumps({"kernels": flagship + kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
