"""Runtime plugin loader (reference libjulius/src/plugin.c +
plugin/plugin_defs.h).

Port of `julius_tpu/plugins.py` (host code, a copy).

The reference dlopen()s `.jpi` shared objects from `-plugindir` and
binds exported C symbols into fixed extension slots (A/D input, audio
postprocess, feature input "fvin", feature postprocess, mixture-calc
override, result receiver, generic callbacks).  Here plugins are plain
Python modules loaded from a directory; the same slots are recognised
by function name:

- ``initialize()``                 — once at load (reference: initialize)
- ``startup(config_str)``          — engine start (reference: startup)
- ``adin_postprocess(samples)``    — mutate/replace captured audio
- ``fvin_postprocess(vec)``        — mutate/replace each feature vector
  (applied to the whole [T, D] utterance here — batched, not per-frame)
- ``result_best_str(text)``        — receive the best sentence string
- ``result_error(code)``           — receive recognition failure
- any attribute ``callbacks``: dict of {event_name: fn} registered on
  every engine's CallbackRegistry (utils/callback.py).

Modules may also call ``engine.register_user_lm`` etc. from
``startup`` — ``startup`` receives the live engine list when loaded
via the CLI tools.
"""

from __future__ import annotations

import importlib.util
import os
import sys
from typing import List

import numpy as np

from julius_tpu_torch.utils.jlog import LogLevel, jlog


class PluginManager:
    """Loads plugin modules and dispatches slot functions
    (reference plugin_load_dir plugin.c)."""

    def __init__(self):
        self.modules: List[object] = []

    def load_dir(self, path: str) -> int:
        """Load every importable .py in `path` (reference scans for the
        .jpi suffix); returns the number of plugins loaded."""
        n = 0
        if not os.path.isdir(path):
            jlog(LogLevel.WARNING, f"plugin dir not found: {path}")
            return 0
        for fname in sorted(os.listdir(path)):
            if not fname.endswith(".py") or fname.startswith("_"):
                continue
            full = os.path.join(path, fname)
            name = "julius_tpu_torch_plugin_" + os.path.splitext(fname)[0]
            try:
                spec = importlib.util.spec_from_file_location(name, full)
                mod = importlib.util.module_from_spec(spec)
                sys.modules[name] = mod
                spec.loader.exec_module(mod)
            except Exception as e:
                jlog(LogLevel.ERROR, f"plugin {fname} failed to load: {e}")
                continue
            if hasattr(mod, "initialize"):
                try:
                    mod.initialize()
                except Exception as e:
                    jlog(LogLevel.ERROR, f"plugin {fname} initialize: {e}")
                    continue
            self.modules.append(mod)
            jlog(LogLevel.STAT, f"plugin loaded: {fname}")
            n += 1
        return n

    # -- slot dispatch ------------------------------------------------------

    def startup(self, engines) -> None:
        for m in self.modules:
            if hasattr(m, "startup"):
                m.startup(engines)
            for name, fn in getattr(m, "callbacks", {}).items():
                for eng in engines:
                    eng.callbacks.add(name, fn)
            if hasattr(m, "result_best_str"):
                fn = m.result_best_str

                def _recv(res, _fn=fn, _m=m):
                    if res is not None and res.valid:
                        _fn(" ".join(t for t in (res.texts or res.words)
                                     if t))
                    elif hasattr(_m, "result_error"):
                        _m.result_error(res.reject_reason
                                        if res is not None else "no result")
                for eng in engines:
                    eng.callbacks.add("result", _recv)

    def adin_postprocess(self, samples: np.ndarray) -> np.ndarray:
        for m in self.modules:
            if hasattr(m, "adin_postprocess"):
                out = m.adin_postprocess(samples)
                if out is not None:
                    samples = np.asarray(out)
        return samples

    def fvin_postprocess(self, vec: np.ndarray) -> np.ndarray:
        for m in self.modules:
            if hasattr(m, "fvin_postprocess"):
                out = m.fvin_postprocess(vec)
                if out is not None:
                    vec = np.asarray(out)
        return vec
