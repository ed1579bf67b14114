"""What a thread-block cluster costs on one NVIDIA card, and how many of
the word-end kernel's clusters it runs at once.

    python3 -m julius_tpu_torch.tools.probe_cluster

Builds tools/cluster_probe.cu (nvcc, sm_90a) and launches its probe once
for each cluster size C of 1, 2, 4, 8 and 256, 512 and 1024 threads a
block: one JSON line each with the SM clock cycles of a cluster.sync(),
a relaxed cluster barrier, a release / acquire one, a cluster-scope
release fence, a block barrier, a dependent load from a peer block's
shared memory and from the block's own, and one mbarrier hop between
two blocks (thread 0 arrives on the peer's barrier, release at cluster
scope).  Then, for the word-end kernel (csrc/word_end.cu) at the
flagship's and the 20k-word configuration's rows, how many clusters of
each (C, threads) the card runs at once
(`cudaOccupancyMaxActiveClusters`).  Ends with the card's name and power
limit.
"""

from __future__ import annotations

import ctypes
import json

import torch

from julius_tpu_torch.ops import cuda_build
from julius_tpu_torch.ops import word_end_kernel as we
from julius_tpu_torch.tools.time_word_end import card_line

SOURCE = cuda_build.PKG / "tools" / "cluster_probe.cu"
FIELDS = ("cluster_sync", "barrier_relaxed", "barrier_release_acquire",
          "fence_acq_rel_cluster", "syncthreads", "dsmem_load", "smem_load",
          "mbarrier_hop")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("probe_cluster: needs a CUDA card")
    cuda_build.compile_all([SOURCE, we.SOURCE])
    lib = cuda_build.load(SOURCE)
    lib.cluster_probe.argtypes = [ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p]
    lib.cluster_probe.restype = ctypes.c_int
    out = (ctypes.c_longlong * len(FIELDS))()
    for C in (1, 2, 4, 8):
        for threads in (256, 512, 1024):
            rc = lib.cluster_probe(C, threads, out)
            if rc != 0:
                raise RuntimeError(f"cluster_probe: CUDA error {rc}")
            print(json.dumps(dict(probe_cycles=dict(
                C=C, threads=threads, **dict(zip(FIELDS, out))))),
                flush=True)
    wlib, d = we.build(), torch.device("cuda", 0)
    for Ex, M in ((5000, 32), (20000, 128)):
        fits = {}
        for C in (1, 2, 4, 8):
            for threads in (256, 512, 1024):
                smem = we.smem_bytes(Ex, M, C, threads, True)
                fits[f"{C}x{threads}"] = we.max_clusters(wlib, d, C, threads,
                                                         smem)
        print(json.dumps(dict(word_end_clusters_at_once=dict(
            exits=Ex, atoms=M, by_c_x_threads=fits))), flush=True)
    print(card_line())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
