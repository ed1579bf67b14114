"""Logging — the `jlog()` equivalent (reference libsent/src/util/jlog.c).

A thin wrapper over the stdlib logger with the reference's STAT/WARNING/ERROR
levels and a redirectable output stream (`jlog_set_output`)."""

from __future__ import annotations

import enum
import sys
from typing import Optional, TextIO


class LogLevel(enum.IntEnum):
    STAT = 0
    WARNING = 1
    ERROR = 2


#: sentinel: resolve sys.stderr at call time (so redirected/captured
#: stderr streams are never retained after they close)
DEFAULT = object()

_out = DEFAULT
_min_level = LogLevel.STAT


def set_log_output(stream: Optional[TextIO]) -> None:
    """Redirect log output; None silences logging; jlog.DEFAULT restores
    the stderr default (reference jlog_set_output)."""
    global _out
    _out = stream


def set_log_level(level: LogLevel) -> None:
    global _min_level
    _min_level = level


def jlog(level: LogLevel, fmt: str, *args) -> None:
    if _out is None or level < _min_level:
        return
    stream = sys.stderr if _out is DEFAULT else _out
    msg = fmt % args if args else fmt
    try:
        print(f"{level.name}: {msg}", file=stream)
    except ValueError:
        pass    # redirected stream was closed by the host application
