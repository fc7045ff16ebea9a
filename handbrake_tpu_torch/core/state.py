"""Engine state machine — mirrors hb_state_t (common.h:1460-1502).

Frontends poll ``Handle.get_state()`` which returns a plain dict in the same shape
as the reference's JSON state (hb_json.c state codec), so existing HandBrake
frontends' polling model maps directly.
"""
from __future__ import annotations

import threading
import time

IDLE = "IDLE"
SCANNING = "SCANNING"
SCANDONE = "SCANDONE"
WORKING = "WORKING"
PAUSED = "PAUSED"
WORKDONE = "WORKDONE"
MUXING = "MUXING"
SEARCHING = "SEARCHING"

# Error codes (HB_ERROR_*)
ERROR_NONE = 0
ERROR_CANCELED = 1
ERROR_WRONG_INPUT = 2
ERROR_INIT = 3
ERROR_UNKNOWN = 4
ERROR_READ = 5


class State:
    """Thread-safe state holder with reference-compatible dict snapshots."""

    def __init__(self):
        self._lock = threading.Lock()
        self._state = IDLE
        self._params: dict = {}

    def set(self, state: str, **params):
        with self._lock:
            self._state = state
            self._params = dict(params)

    def update(self, **params):
        with self._lock:
            self._params.update(params)

    def get(self) -> dict:
        with self._lock:
            s = {"State": self._state}
            if self._state == SCANNING or self._state == SCANDONE:
                s["Scanning"] = {
                    "Progress": self._params.get("progress", 0.0),
                    "Preview": self._params.get("preview", 0),
                    "PreviewCount": self._params.get("preview_count", 0),
                    "Title": self._params.get("title", 0),
                    "TitleCount": self._params.get("title_count", 0),
                    "SequenceID": self._params.get("sequence_id", 0),
                }
            elif self._state in (WORKING, PAUSED, SEARCHING, MUXING):
                s["Working"] = {
                    "Progress": self._params.get("progress", 0.0),
                    "PassID": self._params.get("pass_id", -1),
                    "Pass": self._params.get("pass", 1),
                    "PassCount": self._params.get("pass_count", 1),
                    "Rate": self._params.get("rate", 0.0),
                    "RateAvg": self._params.get("rate_avg", 0.0),
                    "ETASeconds": self._params.get("eta", 0),
                    "Hours": self._params.get("eta", 0) // 3600,
                    "Minutes": (self._params.get("eta", 0) % 3600) // 60,
                    "Seconds": self._params.get("eta", 0) % 60,
                    "SequenceID": self._params.get("sequence_id", 0),
                }
            elif self._state == WORKDONE:
                s["WorkDone"] = {
                    "Error": self._params.get("error", ERROR_NONE),
                    "SequenceID": self._params.get("sequence_id", 0),
                }
            return s


class Progress:
    """Per-job progress/rate tracking (sync.c UpdateState analog)."""

    def __init__(self, total_frames: int, publish, sequence_id: int = 0,
                 pass_no: int = 1, pass_count: int = 1):
        self.total = max(1, total_frames)
        self.publish = publish
        self.count = 0
        self.t0 = time.monotonic()
        self.last_t = self.t0
        self.last_count = 0
        self.sequence_id = sequence_id
        self.pass_no = pass_no
        self.pass_count = pass_count

    def tick(self, n: int = 1):
        self.count += n
        now = time.monotonic()
        if now - self.last_t >= 0.25 or self.count >= self.total:
            dt = max(1e-6, now - self.t0)
            rate_avg = self.count / dt
            inst_dt = max(1e-6, now - self.last_t)
            rate = (self.count - self.last_count) / inst_dt
            eta = int((self.total - self.count) / max(rate_avg, 1e-6))
            self.publish(progress=min(1.0, self.count / self.total),
                         rate=rate, rate_avg=rate_avg, eta=eta,
                         sequence_id=self.sequence_id,
                         pass_=self.pass_no)
            self.last_t, self.last_count = now, self.count
