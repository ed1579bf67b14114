"""Trellis / search-space visualizer — the `julius/visual.c` analog.

The reference's GTK visualizer (VISUALIZE build, `julius/visual.c`,
2,259 LoC) draws the pass-1 word trellis and the pass-2 pop locations
over time.  Here the same picture is rendered as a standalone SVG (no
GUI toolkit in scope) or plain text: every surviving trellis atom is a
horizontal bar [begin_frame, end_frame] colored by relative score, the
pass-1 best path is highlighted, and pass-2 N-best word boundaries are
overlaid as ticks.

    python -m julius_tpu_torch.tools.visualize -C run.jconf utt.mfc \\
        -o utt.svg

Port of `julius_tpu/tools/visualize.py`: the renderers are a copy; the
trellis comes from the port's engine on the card (`main(argv,
device="cpu")` on the CPU), copied to numpy once.
"""

from __future__ import annotations

import sys
from typing import List

import numpy as np


def _collect_atoms(tr, n_frames: int) -> List[dict]:
    word = np.asarray(tr.word)
    score = np.asarray(tr.score)
    begin = np.asarray(tr.begin)
    T, M = word.shape
    T = min(T, n_frames)
    out = []
    for t in range(T):
        for m in range(M):
            w = int(word[t, m])
            if w < 0:
                continue
            out.append(dict(word=w, begin=int(begin[t, m]), end=t,
                            score=float(score[t, m]), atom=(t, m)))
    return out


def _best_path_atoms(tr, n_frames: int) -> set:
    """Atom ids (t, m) on the pass-1 best backtrace."""
    word = np.asarray(tr.word)
    score = np.asarray(tr.score)
    prev = np.asarray(tr.prev)
    T, M = word.shape
    t_last = n_frames - 1
    row = np.where(word[t_last] >= 0, score[t_last], -np.inf)
    if not np.isfinite(row).any():
        return set()
    m = int(np.argmax(row))
    path = set()
    a = t_last * M + m
    while a >= 0:
        t, mm = divmod(a, M)
        path.add((t, mm))
        a = int(prev[t, mm])
    return path


def trellis_to_text(tr, n_frames: int, names: List[str],
                    max_atoms: int = 500) -> str:
    """Sorted text dump (the -debug trellis listing of the reference)."""
    atoms = _collect_atoms(tr, n_frames)
    best = _best_path_atoms(tr, n_frames)
    atoms.sort(key=lambda a: (a["end"], -a["score"]))
    lines = [f"# trellis: {len(atoms)} atoms, {n_frames} frames"]
    for a in atoms[:max_atoms]:
        mark = "*" if a["atom"] in best else " "
        lines.append(f"{mark} [{a['begin']:4d}..{a['end']:4d}] "
                     f"{a['score']:12.3f}  {names[a['word']]}")
    if len(atoms) > max_atoms:
        lines.append(f"... ({len(atoms) - max_atoms} more)")
    return "\n".join(lines)


def trellis_to_svg(tr, n_frames: int, names: List[str],
                   nbest=None, width: int = 1000,
                   row_h: int = 14) -> str:
    """SVG rendering: one lane per atom (packed greedily), bar span =
    word duration, opacity = score rank, red outline = pass-1 best
    path, dashed verticals = pass-2 best-sentence boundaries."""
    atoms = _collect_atoms(tr, n_frames)
    best = _best_path_atoms(tr, n_frames)
    if not atoms:
        return ("<svg xmlns='http://www.w3.org/2000/svg' width='100' "
                "height='20'><text y='15'>empty trellis</text></svg>")
    smin = min(a["score"] for a in atoms)
    smax = max(a["score"] for a in atoms)
    rng = max(smax - smin, 1e-6)
    # greedy lane packing by begin frame
    atoms.sort(key=lambda a: (a["begin"], a["end"]))
    lane_end: List[int] = []
    for a in atoms:
        for i, e in enumerate(lane_end):
            if a["begin"] > e:
                a["lane"] = i
                lane_end[i] = a["end"]
                break
        else:
            a["lane"] = len(lane_end)
            lane_end.append(a["end"])
    n_lanes = len(lane_end)
    sx = width / max(n_frames, 1)
    h = (n_lanes + 2) * row_h
    out = [f"<svg xmlns='http://www.w3.org/2000/svg' width='{width}' "
           f"height='{h}' font-family='monospace' font-size='10'>"]
    out.append(f"<rect width='{width}' height='{h}' fill='white'/>")
    for a in atoms:
        x = a["begin"] * sx
        wpx = max((a["end"] - a["begin"] + 1) * sx, 2.0)
        y = (a["lane"] + 1) * row_h
        op = 0.25 + 0.75 * (a["score"] - smin) / rng
        stroke = ("stroke='red' stroke-width='1.5'"
                  if a["atom"] in best else "stroke='none'")
        out.append(f"<rect x='{x:.1f}' y='{y}' width='{wpx:.1f}' "
                   f"height='{row_h - 2}' fill='steelblue' "
                   f"fill-opacity='{op:.2f}' {stroke}/>")
        label = names[a["word"]]
        if wpx > 6 * len(label):
            out.append(f"<text x='{x + 2:.1f}' y='{y + row_h - 4}' "
                       f"fill='black'>{label}</text>")
    if nbest:
        hyp = nbest[0]
        for seg in getattr(hyp, "segments", None) or []:
            x = seg["end"] * sx
            out.append(f"<line x1='{x:.1f}' y1='0' x2='{x:.1f}' "
                       f"y2='{h}' stroke='darkorange' "
                       "stroke-dasharray='4,3'/>")
    out.append(f"<text x='2' y='{h - 2}' fill='gray'>frames 0..{n_frames}"
               f", atoms {len(atoms)}, lanes {n_lanes}</text>")
    out.append("</svg>")
    return "\n".join(out)


def main(argv=None, device="cuda"):
    argv = argv if argv is not None else sys.argv[1:]
    import torch

    from julius_tpu_torch.fusion import create_engines
    from julius_tpu_torch.io.htk_param import read_htk_param
    from julius_tpu_torch.io.wav import read_audio
    from julius_tpu_torch.jconf import parse_jconf
    from julius_tpu_torch.search.pass1 import Trellis

    out_path = None
    if "-o" in argv:
        k = argv.index("-o")
        out_path = argv[k + 1]
        argv = argv[:k] + argv[k + 2:]
    text_mode = "-text" in argv
    argv = [a for a in argv if a != "-text"]
    files = [a for a in argv if not a.startswith("-") and
             (a.endswith(".mfc") or a.endswith(".wav") or
              a.endswith(".raw") or a.endswith(".prob"))]
    opts = [a for a in argv if a not in files]
    cfg = parse_jconf(opts)
    engines = create_engines(cfg, device=device)
    eng = engines[0]
    for path in files:
        with torch.no_grad():
            if cfg.input_source in ("mfcfile", "htkparam") or \
                    path.endswith(".mfc"):
                param = read_htk_param(path)
                nfr = param.data.shape[0]
                out_ext = eng._outprob(torch.as_tensor(
                    param.data[None], device=eng.device))
                trellis = eng._pass1(out_ext, [nfr])
            else:
                wave = read_audio(path)
                trellis, nfr_d, _out = eng._decode_device(
                    torch.as_tensor(wave[None], dtype=torch.float32,
                                    device=eng.device),
                    torch.as_tensor([len(wave)], dtype=torch.int32,
                                    device=eng.device))
                nfr = int(nfr_d[0])
        tb = Trellis(*[a[0].cpu().numpy() for a in trellis])
        res = eng._pass2_result(tb, nfr) if eng.search_cfg.enable_pass2 \
            else None
        nbest = [res] if res is not None else None
        if text_mode:
            txt = trellis_to_text(tb, nfr, eng.voca.names)
            dest = out_path or (path + ".trellis.txt")
            with open(dest, "w") as f:
                f.write(txt + "\n")
        else:
            svg = trellis_to_svg(tb, nfr, eng.voca.names, nbest=nbest)
            dest = out_path or (path + ".svg")
            with open(dest, "w") as f:
                f.write(svg + "\n")
        print(f"visualized {path} -> {dest}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
