"""glog-style logging + CHECK assertions (a pure-Python copy of
``nct_tpu/utils/glog.py``).

The vendored Caffe logs through Google glog everywhere (``LOG(INFO)`` /
``LOG(ERROR)`` and ``CHECK_*`` assertions are ubiquitous; reference:
code/src/caffe uses them in nearly every file, and tools/extra/parse_log.py
parses the resulting format).  This module supplies the same surface:

  * ``info/warning/error/fatal(msg)`` — glog line format
    ``<L><mmdd> <HH:MM:SS.uuuuuu> <tid> <file>:<line>] <msg>`` so
    existing glog-aware tooling (and tools/parse_log.py) reads it;
  * severity filtering via ``set_min_log_level`` or the
    ``NCT_MINLOGLEVEL`` env var (0=INFO .. 3=FATAL, glog's numbering);
  * ``CHECK / CHECK_EQ / NE / LT / LE / GT / GE / CHECK_NOTNONE`` —
    raising :class:`CheckError` with glog-style operand rendering
    (``Check failed: a == b (3 vs. 4)``);
  * ``FATAL`` logs then raises.

Plain ``print`` remains fine for user-facing CLI output; framework-internal
diagnostics route through here.
"""

from __future__ import annotations

import inspect
import os
import sys
import threading
import time

INFO, WARNING, ERROR, FATAL = 0, 1, 2, 3
_LETTER = "IWEF"

_min_level = int(os.environ.get("NCT_MINLOGLEVEL", "0"))
_stream = None          # None -> sys.stderr resolved at call time


class CheckError(AssertionError):
    """A failed CHECK_* (glog aborts; we raise)."""


def set_min_log_level(level: int) -> None:
    global _min_level
    _min_level = int(level)


def set_stream(stream) -> None:
    """Redirect log output (tests); None restores stderr."""
    global _stream
    _stream = stream


def _emit(level: int, msg: str, depth: int = 2) -> None:
    if level < _min_level:
        return
    frame = inspect.stack()[depth]
    fname = os.path.basename(frame.filename)
    now = time.time()
    lt = time.localtime(now)
    usec = int((now % 1) * 1e6)
    line = (f"{_LETTER[level]}{lt.tm_mon:02d}{lt.tm_mday:02d} "
            f"{lt.tm_hour:02d}:{lt.tm_min:02d}:{lt.tm_sec:02d}.{usec:06d} "
            f"{threading.get_native_id()} {fname}:{frame.lineno}] {msg}")
    out = _stream if _stream is not None else sys.stderr
    print(line, file=out, flush=True)


def info(msg: str) -> None:
    _emit(INFO, msg)


def warning(msg: str) -> None:
    _emit(WARNING, msg)


def error(msg: str) -> None:
    _emit(ERROR, msg)


def fatal(msg: str, _depth: int = 2) -> None:
    # _depth: inspect.stack() index of the frame to attribute the line to
    # (2 = fatal's direct caller; log() passes 3 so the emitted file:line
    # points at the external call site, not at glog.py itself).
    _emit(FATAL, msg, depth=_depth)
    raise CheckError(msg)


def log(level: int, msg: str) -> None:
    if level >= FATAL:
        fatal(msg, _depth=3)
    else:
        _emit(level, msg)


def CHECK(cond, msg: str = "") -> None:
    if not cond:
        text = f"Check failed: {msg}" if msg else "Check failed"
        _emit(FATAL, text)
        raise CheckError(text)


def _binary(name: str, op, a, b, msg: str) -> None:
    if not op(a, b):
        text = (f"Check failed: {name} ({a!r} vs. {b!r})"
                + (f" {msg}" if msg else ""))
        _emit(FATAL, text, depth=3)
        raise CheckError(text)


def CHECK_EQ(a, b, msg: str = "") -> None:
    _binary("a == b", lambda x, y: x == y, a, b, msg)


def CHECK_NE(a, b, msg: str = "") -> None:
    _binary("a != b", lambda x, y: x != y, a, b, msg)


def CHECK_LT(a, b, msg: str = "") -> None:
    _binary("a < b", lambda x, y: x < y, a, b, msg)


def CHECK_LE(a, b, msg: str = "") -> None:
    _binary("a <= b", lambda x, y: x <= y, a, b, msg)


def CHECK_GT(a, b, msg: str = "") -> None:
    _binary("a > b", lambda x, y: x > y, a, b, msg)


def CHECK_GE(a, b, msg: str = "") -> None:
    _binary("a >= b", lambda x, y: x >= y, a, b, msg)


def CHECK_NOTNONE(x, msg: str = ""):
    if x is None:
        text = ("Check failed: value is not None"
                + (f" {msg}" if msg else ""))
        _emit(FATAL, text)
        raise CheckError(text)
    return x
