"""Device selection for the port's entry points, and the f32 product
precision they pin."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on.  CUDA is the default;
    the CPU is used only when the caller asks for it, so a machine
    without a card raises instead of silently decoding on the host."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


@contextlib.contextmanager
def full_f32_matmul():
    """Run float32 matrix products in full float32 inside the block and
    restore the caller's setting after it.  The reference pins its f32
    products at HIGHEST; a caller that allows TF32 (a 10-bit mantissa,
    a relative error of 4.9e-4) would otherwise round Gaussian scores
    and features far beyond the port's tolerances."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)
