"""julius_tpu_torch — the PyTorch/CUDA port of julius_tpu for NVIDIA Hopper.

A second package beside `julius_tpu` (the JAX reference, which it never
imports).  Its layout mirrors the reference's so each module's
counterpart is easy to find:
  io/, models/, config.py, jconf.py, grammar.py - host model formats,
             DFA grammars and the mkdfa compiler, options (copies)
  frontend/ - the waveform front end, its streaming version (MAP-CMN,
             VADs) and the GMM verification / GMM-VAD front end
  adin/    - the native audio-input segmenter, decimator and capture
             (C++, adin/native/adin.cpp, built with g++)
  ops/     - DNN and GMM senone scoring (torch), the pass-1 beam-update
             and word-end kernels and the pass-2 word-scan kernel
             (hand-written CUDA, csrc/pass1_step.cu, csrc/word_end.cu,
             csrc/scan_win.cu)
  search/  - flat decode network, device N-gram hash, pass-1 Viterbi
             (kernel path, unfused step, stream chunks), pass 2 (device
             A*, host re-scan, frozen N-gram and DFA searches), word
             graphs, forced alignment
  engine.py - Engine.decode_features / recognize_batch, the batched
             decode entry points; streaming.py StreamSession, the live
             one; fusion.py, tools/recognize.py the command line
             (plugins.py: -plugindir)
  server/  - the module control/result protocol, adinnet audio input
             and vecnet feature input; tools/serve.py runs the server,
             tools/jcontrol.py and tools/adintool.py are its clients
  tools/   - besides those: model checks (checkmodel.py), the stage
             profiler (profile.py), model and grammar tools
             (modeltools.py), WER scoring (wer.py), the trellis
             visualizer (visualize.py), the synthetic models (synth.py)
             and the julius 4.6 binary's exports and parity runs
             (refbaseline.py, refparity.py)
  parallel/ - a dp x tp mesh of torch devices in one process: the
             batch split over dp, the DNN over tp (mesh.py), pass 1 over
             word-aligned network shards (sharded_pass1.py)
  cache.py  - the on-disk network cache
  convert.py - carries the reference's parameters and tables across

Entry points run on CUDA unless the caller passes device="cpu".
"""

__version__ = "0.1.0"

from julius_tpu_torch.config import (  # noqa: F401
    AMConfig,
    FrontendConfig,
    SearchConfig,
)
