"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under `julius_tpu_torch/csrc/` compiles on its own into a
shared library with a plain C interface, for `sm_90a`, into the
git-ignored `julius_tpu_torch/_build/`, named by a hash of the source
and the flags, so a changed source builds anew and an unchanged one is
loaded as it is.  A source may be built a second time with extra flags
(a measurement build, e.g. `-DWORD_END_PHASES`) into a library of its
own.  The ptxas report (registers, spills) lands beside each
library as `.log`.  `compile_all` starts one nvcc per missing library,
all at once, and waits for them together.  A launch through such a
library runs on the CUDA runtime's current device, so the wrappers make
their tensors' card current around it (`on_device`).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Sequence, Tuple, Union

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[Tuple[Path, Tuple[str, ...]], ctypes.CDLL] = {}
#: a source, or a source and the extra nvcc flags of its build
Job = Union[Path, Tuple[Path, Sequence[str]]]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or add it to PATH")
    return found


def library_path(source: Path, extra: Sequence[str] = ()) -> Path:
    """Where `source`'s library lives, keyed by source and flags."""
    flags = [*NVCC_FLAGS, *extra]
    tag = hashlib.sha256(source.read_bytes()
                         + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{source.stem}_{tag[:16]}.so"


def compile_all(jobs_in: Iterable[Job]) -> None:
    """Compile every source (or (source, extra flags)) whose library is
    missing, one nvcc process each, all started together.  Raises with
    nvcc's output on failure."""
    jobs = []
    for job in jobs_in:
        src, extra = (job, ()) if isinstance(job, Path) else job
        so = library_path(src, extra)
        if so.exists():
            continue
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, *extra, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((src, so, tmp, proc))
    errors = []
    for src, so, tmp, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src.name} ({proc.returncode}):"
                          f"\n{out}")
            continue
        so.with_suffix(".log").write_text(out)
        os.replace(tmp, so)
    if errors:
        raise RuntimeError("\n".join(errors))


def load(source: Path, extra: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library of `source` (built with the `extra` nvcc
    flags), compiled first if missing."""
    key = (source, tuple(extra))
    lib = _loaded.get(key)
    if lib is None:
        compile_all([(source, tuple(extra))])
        lib = ctypes.CDLL(str(library_path(source, extra)))
        _loaded[key] = lib
    return lib


def ptxas_report(source: Path, extra: Sequence[str] = ()) -> str:
    """nvcc's ptxas report for `source`'s library ('' if not built
    here)."""
    log = library_path(source, extra).with_suffix(".log")
    return log.read_text().strip() if log.exists() else ""


def check_arg(name, t, dtype, shape, device) -> None:
    """Raise unless tensor `t` lies on `device` with `dtype` and
    `shape` (a kernel takes nothing else)."""
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def on_device(dev: torch.device):
    """A context in which card `dev` is the current CUDA device: a
    `torch.cuda.device(dev)` when another card is current (the current
    device is per thread), else nothing to enter."""
    if torch.cuda.current_device() == dev.index:
        return contextlib.nullcontext()
    return torch.cuda.device(dev)
