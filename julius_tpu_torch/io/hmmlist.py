"""HMMList reader — logical triphone name -> physical model mapping.

Reference: libsent/src/hmminfo/rdhmmlist.c.  Each line is
``logicalname [physicalname]``; a missing physical name means the logical
name maps to the physical model of the same name."""

from __future__ import annotations

from typing import Dict

from julius_tpu_torch.models.hmm import HMMSet


def load_hmmlist(path: str, hmm: HMMSet) -> Dict[str, int]:
    """Load HMMList and install the logical map into ``hmm``. Returns it."""
    mapping: Dict[str, int] = {}
    with open(path, "rt", encoding="latin-1") as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            logical = parts[0]
            physical = parts[1] if len(parts) > 1 else parts[0]
            pid = hmm.phone_index.get(physical)
            if pid is None:
                raise ValueError(
                    f"{path}:{lineno}: physical model '{physical}' not in hmmdefs")
            if logical in mapping:
                raise ValueError(f"{path}:{lineno}: duplicate logical '{logical}'")
            mapping[logical] = pid
    hmm.logical_map = mapping
    return mapping
