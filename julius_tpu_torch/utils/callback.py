"""Event/result callback registry (reference libjulius/src/callback.c +
include/julius/callback.h:37-239).

The reference exposes 30+ hook points on the engine (CALLBACK_EVENT_*,
CALLBACK_RESULT*, CALLBACK_POLL ...), each holding a list of registered
functions (callback_add / callback_exec, multi-hook registry on Recog,
recog.h:1241-1266).  Here the registry is a plain name -> [fn] map; the
engine and StreamSession fire the same logical events.  Results are
also *returned* as values (the idiomatic Python surface) — callbacks
exist for streaming consumers (module server, live apps) that need
push-style delivery.

Event names fired by the framework (reference counterpart in parens):

- ``event_stream_begin`` / ``event_stream_end``  (SPEECH_READY / STREAM_END)
- ``event_speech_start`` / ``event_speech_stop`` (SPEECH_START / SPEECH_STOP)
- ``event_recognition_begin`` / ``event_recognition_end``
- ``event_pass1_begin`` / ``event_pass1_end``    (PASS1_BEGIN / PASS1_END)
- ``result_pass1_interim``                       (RESULT_PASS1_INTERIM, -progout)
- ``result_pass1``                               (RESULT_PASS1)
- ``event_pass2_begin``                          (PASS2_BEGIN)
- ``result``                                     (CALLBACK_RESULT)
- ``poll``                                       (CALLBACK_POLL)
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, Tuple


class CallbackRegistry:
    """callback_add/callback_delete/callback_exec equivalent."""

    def __init__(self):
        self._hooks: Dict[str, List[Tuple[int, Callable]]] = {}
        self._ids = itertools.count(1)

    def add(self, name: str, fn: Callable, *extra_names: str) -> int:
        """Register fn under one or more event names; returns an id
        usable with delete() (reference callback_add callback.c)."""
        cid = next(self._ids)
        for n in (name, *extra_names):
            self._hooks.setdefault(n, []).append((cid, fn))
        return cid

    def delete(self, cb_id: int) -> bool:
        found = False
        for lst in self._hooks.values():
            before = len(lst)
            lst[:] = [(i, f) for (i, f) in lst if i != cb_id]
            found = found or len(lst) != before
        return found

    def exec(self, name: str, *args: Any, **kw: Any) -> None:
        """Fire all callbacks registered for `name` in add order
        (reference callback_exec)."""
        for _, fn in self._hooks.get(name, []):
            fn(*args, **kw)

    def exists(self, name: str) -> bool:
        return bool(self._hooks.get(name))
