"""julius_tpu_torch — the PyTorch/CUDA port of julius_tpu for NVIDIA Hopper.

A second package beside `julius_tpu` (the JAX reference, which it never
imports).  Its layout mirrors the reference's so each module's
counterpart is easy to find:
  io/, models/, config.py - host model formats and tables (copies)
  ops/     - DNN senone scoring (torch) and the pass-1 beam-update
             kernel (hand-written CUDA, csrc/pass1_step.cu)
  search/  - flat decode network, device N-gram hash, pass-1 Viterbi,
             pass-2 frozen-score stack search
  engine.py - Engine.decode_features, the batched decode entry point
  convert.py - carries the reference's parameters and tables across

Entry points run on CUDA unless the caller passes device="cpu".
"""

__version__ = "0.1.0"

from julius_tpu_torch.config import (  # noqa: F401
    AMConfig,
    FrontendConfig,
    SearchConfig,
)
