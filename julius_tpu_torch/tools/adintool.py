"""Audio front-end tool: detect speech segments and route them.

Port of `julius_tpu/tools/adintool.py`.  Reference: `adintool/`
(multi I/O audio frontend: mic/file/stdin/adinnet in ->
file/adinnet/vecnet/stdout out) and `adinrec/` (record one
segment).  Microphone input uses the native capture layer
(adin/native/adin.cpp: ALSA / PulseAudio / OSS via dlopen); pass
`-in fake:file.wav` to replay a file through the same capture path on
machines without audio devices.

    python -m julius_tpu_torch.tools.adintool -in file -filename x.wav \\
        -out file -filename-out seg        # seg.0001.wav, ...
    python -m julius_tpu_torch.tools.adintool -in file -filename x.wav \\
        -out adinnet -server host:5530
    python -m julius_tpu_torch.tools.adintool -in file -filename x.wav \\
        -out vecnet -server host:5531      # sends feature vectors

`-out vecnet` runs the front end (frontend/mfcc.py) on the card;
`main(argv, device="cpu")` runs it on the CPU.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from julius_tpu_torch.adin.native_wrapper import (make_capture,
                                                  make_speech_detector)
from julius_tpu_torch.config import FrontendConfig
from julius_tpu_torch.frontend import mfcc as fe
from julius_tpu_torch.frontend.stream import VADConfig
from julius_tpu_torch.io.wav import read_audio, write_wav
from julius_tpu_torch.server.adinnet import ADINNET_PORT, AdinnetClient
from julius_tpu_torch.server.vecnet import VECNET_PORT, VecnetClient
from julius_tpu_torch.utils.device import resolve_device


def main(argv=None, device="cuda"):
    argv = argv if argv is not None else sys.argv[1:]
    device = resolve_device(device)
    opts = {"-in": "file", "-out": "file", "-filename": None,
            "-filename-out": "segment", "-server": "127.0.0.1",
            "-lv": "2000", "-zc": "60", "-headmargin": "300",
            "-tailmargin": "400", "-freq": "16000", "-nosegment": None,
            "-duration": "0"}
    i = 0
    flags = set()
    while i < len(argv):
        a = argv[i]
        if a in ("-nosegment", "-oneshot"):
            flags.add(a)
        elif a in opts:
            opts[a] = argv[i + 1]
            i += 1
        else:
            print(f"unknown option {a}", file=sys.stderr)
            return 1
        i += 1

    sr = int(opts["-freq"])
    if opts["-in"] == "file":
        if not opts["-filename"]:
            print("need -filename", file=sys.stderr)
            return 1
        audio = read_audio(opts["-filename"])
    elif opts["-in"] == "stdin":
        audio = np.frombuffer(sys.stdin.buffer.read(),
                              dtype="<i2").astype(np.float32)
    elif opts["-in"] in ("mic", "auto", "alsa", "pulseaudio", "oss") \
            or opts["-in"].startswith("fake:"):
        cap = make_capture(opts["-in"], rate=sr)
        chunks = []
        limit = float(opts.get("-duration") or "0")
        got = 0
        while True:
            c = cap.read(4000)
            if c is None:
                break
            chunks.append(c)
            got += len(c)
            if limit and got >= limit * sr:
                break
        cap.close()
        audio = (np.concatenate(chunks) if chunks
                 else np.zeros(0, np.float32))
    else:
        print(f"unsupported -in {opts['-in']}", file=sys.stderr)
        return 1

    # segment
    if "-nosegment" in flags:
        segments = [audio]
    else:
        cfg = VADConfig(level=int(opts["-lv"]), zc_thres=int(opts["-zc"]),
                        head_margin_ms=int(opts["-headmargin"]),
                        tail_margin_ms=int(opts["-tailmargin"]),
                        sample_rate=sr)
        det = make_speech_detector(cfg)
        segments = []
        cur = []
        for ofs in range(0, len(audio), 16000):
            for ev in det.feed(audio[ofs: ofs + 16000]):
                if ev["type"] == "samples":
                    cur.append(ev["data"])
                elif ev["type"] == "end" and cur:
                    segments.append(np.concatenate(cur))
                    cur = []
        if cur:
            segments.append(np.concatenate(cur))
    if "-oneshot" in flags:
        segments = segments[:1]

    # route
    host, _, port = opts["-server"].partition(":")
    if opts["-out"] == "file":
        for k, seg in enumerate(segments, 1):
            path = f"{opts['-filename-out']}.{k:04d}.wav"
            write_wav(path, seg, sr)
            print(f"wrote {path} ({len(seg) / sr:.2f}s)")
    elif opts["-out"] == "adinnet":
        cli = AdinnetClient(host=host or "127.0.0.1",
                            port=int(port or ADINNET_PORT))
        for seg in segments:
            cli.send_samples(seg)
            cli.send_segment_end()
        cli.close()
        print(f"sent {len(segments)} segment(s) over adinnet")
    elif opts["-out"] == "vecnet":
        cfg = FrontendConfig(sample_rate=sr)
        tables = fe.build_tables(cfg)
        cli = None
        for seg in segments:
            with torch.no_grad():
                feats, mask = fe.extract_features(
                    torch.as_tensor(np.asarray(seg, np.float32)[None],
                                    device=device),
                    torch.as_tensor([len(seg)], device=device), tables)
            T = int(mask.sum())
            rows = feats[0][:T].cpu().numpy()
            if cli is None:
                cli = VecnetClient(veclen=rows.shape[1],
                                   host=host or "127.0.0.1",
                                   port=int(port or VECNET_PORT))
            cli.send_frames(rows)
            cli.send_segment_end()
        if cli:
            cli.send_stream_end()
            cli.close()
        print(f"sent {len(segments)} feature segment(s) over vecnet")
    elif opts["-out"] == "stdout":
        for seg in segments:
            sys.stdout.buffer.write(
                np.clip(seg, -32768, 32767).astype("<i2").tobytes())
    else:
        print(f"unsupported -out {opts['-out']}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
