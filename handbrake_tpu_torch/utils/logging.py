"""Logging — hb_log/hb_error/hb_deep_log analog (internal.h:23-34).

A registered logger callback receives every line (hb_register_logger analog),
so frontends can redirect engine output.
"""
from __future__ import annotations

import sys
import threading
import time

_lock = threading.Lock()
_verbosity = 1
_logger_cb = None


def set_verbosity(v: int):
    global _verbosity
    _verbosity = v


def register_logger(cb):
    global _logger_cb
    _logger_cb = cb


def _emit(line: str):
    if _logger_cb is not None:
        _logger_cb(line)
    else:
        with _lock:
            print(line, file=sys.stderr, flush=True)


def _stamp() -> str:
    t = time.time()
    lt = time.localtime(t)
    return "[%02d:%02d:%02d]" % (lt.tm_hour, lt.tm_min, lt.tm_sec)


def log(fmt, *args):
    _emit("%s hbtpu: %s" % (_stamp(), (fmt % args) if args else fmt))


def error(fmt, *args):
    _emit("%s hbtpu: ERROR: %s" % (_stamp(), (fmt % args) if args else fmt))


def deep_log(level, fmt, *args):
    if _verbosity >= level:
        log(fmt, *args)
