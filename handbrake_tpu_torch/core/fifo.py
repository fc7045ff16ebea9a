"""Bounded FIFOs — the only cross-stage channel in the pipeline.

Semantics from the reference (libhb/fifo.c + internal.h:202-218): bounded capacity,
blocking push/get with cooperative-cancel checks, and an EOF convention (an explicit
EOF buffer terminates the stream; stages forward it downstream and exit).

Capacities mirror work.c:40-47.
"""
from __future__ import annotations

import collections
import threading
from typing import Optional

from .buffer import Buffer

FIFO_MINI = 4
FIFO_SMALL = 16
FIFO_LARGE = 32
FIFO_UNBOUNDED = 65536


class Fifo:
    def __init__(self, capacity: int = FIFO_LARGE, name: str = ""):
        self.capacity = capacity
        self.name = name
        self._q: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._closed = False

    def __len__(self):
        with self._lock:
            return len(self._q)

    def close(self):
        """Abort: wake all waiters; pushes become no-ops, gets drain then None."""
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    @property
    def closed(self):
        return self._closed

    def push(self, buf: Buffer, timeout: Optional[float] = None) -> bool:
        """Blocking push (hb_fifo_push_wait). Returns False if closed."""
        with self._lock:
            while len(self._q) >= self.capacity and not self._closed:
                self._not_full.wait(timeout)
                if timeout is not None and len(self._q) >= self.capacity:
                    return False
            if self._closed:
                return False
            self._q.append(buf)
            self._not_empty.notify()
            return True

    def push_list(self, bufs) -> bool:
        ok = True
        for b in bufs:
            ok = self.push(b) and ok
        return ok

    def get(self, timeout: Optional[float] = None) -> Optional[Buffer]:
        """Blocking get (hb_fifo_get_wait). None when closed+empty or timeout."""
        with self._lock:
            while not self._q and not self._closed:
                self._not_empty.wait(timeout)
                if timeout is not None and not self._q:
                    return None
            if not self._q:
                return None
            buf = self._q.popleft()
            self._not_full.notify()
            return buf

    def peek(self) -> Optional[Buffer]:
        with self._lock:
            return self._q[0] if self._q else None

    def is_full(self) -> bool:
        with self._lock:
            return len(self._q) >= self.capacity
