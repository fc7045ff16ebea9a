"""Pipeline substrate: work objects, filter objects, and the threaded stage graph.

Modeled on the reference's contracts:
  - work object   (common.h:1545-1597):  init(job) / work(in)->list[out] / close();
    one thread per object (hb_work_loop, work.c:2434) connected by bounded FIFOs.
  - filter object (common.h:1670-1711):  init(FilterInit) negotiates geometry/pix
    fmt/framerate; work() same shape (filter_loop, work.c:2518).

Port notes: a "work" call may internally batch many frames into one device
step; the stage graph is still host threads + FIFOs because IO, entropy coding and
mux are host-sequential. Stages only touch FIFOs, never each other (reference
invariant). The `die` flag is cooperative cancellation (work.c:2439).
"""
from __future__ import annotations

import dataclasses
import threading
import traceback
from typing import List, Optional

from .buffer import Buffer, BufFlags
from .fifo import Fifo
from ..utils import logging as hblog


@dataclasses.dataclass
class FilterInit:
    """Negotiation struct (hb_filter_init_t analog, common.h:1652-1668).

    Filters mutate these fields in init(); the pipeline threads the result into
    the next filter, then the encoder (work.c:1831-1877).
    """
    pix_fmt: object = None
    width: int = 0
    height: int = 0
    par_num: int = 1
    par_den: int = 1
    crop: tuple = (0, 0, 0, 0)     # top, bottom, left, right (applied by filter)
    vrate_num: int = 30000
    vrate_den: int = 1001
    cfr: int = 0                    # 0=vfr 1=cfr 2=pfr
    grayscale: bool = False
    color: dict = dataclasses.field(default_factory=dict)  # primaries/transfer/matrix/range
    job: object = None
    geometry_only: bool = False     # preview path: only negotiate, no device init


class WorkObject:
    """Base class for pipeline stages (decoders, sync, encoders, mux)."""
    name = "work"

    def __init__(self):
        self.fifo_in: Optional[Fifo] = None
        self.fifo_out: Optional[Fifo] = None
        self.done = False
        self.status = 0

    def init(self, job) -> int:
        return 0

    def work(self, buf: Optional[Buffer]) -> List[Buffer]:
        """Process one input buffer; return output buffers.

        On EOF input the object must flush and return its tail followed by the
        EOF buffer itself (reference convention: EOF propagates downstream).
        """
        raise NotImplementedError

    def close(self):
        pass

    # Generator objects (reader) have no fifo_in; they override generate().
    def generate(self):
        raise NotImplementedError


class FilterObject:
    """Base class for video filters."""
    name = "filter"
    skip = False   # disabled during init → pipeline drops it (work.c:1852-1859)

    def __init__(self, settings: Optional[dict] = None):
        self.settings = dict(settings or {})

    def init(self, fi: FilterInit) -> int:
        """Negotiate output geometry/format by mutating fi. Return 0 on success."""
        return 0

    def work(self, buf: Buffer) -> List[Buffer]:
        raise NotImplementedError

    def flush(self) -> List[Buffer]:
        """Emit any internally-queued frames at EOF."""
        return []

    def close(self):
        pass


class _StageThread(threading.Thread):
    def __init__(self, target, name):
        super().__init__(name=name, daemon=True)
        self._target_fn = target
        self.exc = None

    def run(self):
        try:
            self._target_fn()
        except Exception as e:  # noqa: BLE001 — stage failures must not kill the process
            self.exc = e
            hblog.error("stage %s failed: %s\n%s", self.name, e,
                        traceback.format_exc())


class Pipeline:
    """Owns the stage threads + FIFOs for one job pass (do_job's runtime half)."""

    def __init__(self):
        self.die = threading.Event()
        self.threads: List[_StageThread] = []
        self.fifos: List[Fifo] = []
        self.error: Optional[Exception] = None

    def make_fifo(self, capacity, name="") -> Fifo:
        f = Fifo(capacity, name)
        self.fifos.append(f)
        return f

    # ---- loops ----

    def _work_loop(self, w: WorkObject):
        """hb_work_loop analog: fifo_get → w.work → fifo_push (work.c:2434)."""
        while not self.die.is_set():
            buf = w.fifo_in.get(timeout=0.25)
            if buf is None:
                if w.fifo_in.closed:
                    break
                continue
            outs = w.work(buf)
            for o in outs:
                if w.fifo_out is not None and not w.fifo_out.push(o):
                    break
            if buf.is_eof():
                break
        w.done = True

    def _generator_loop(self, w: WorkObject):
        """Reader-style stage: no fifo_in (reader.c:18)."""
        for buf in w.generate():
            if self.die.is_set():
                break
            if w.fifo_out is not None and not w.fifo_out.push(buf):
                break
        w.done = True

    def _filter_loop(self, f: FilterObject, fifo_in: Fifo, fifo_out: Fifo):
        """filter_loop analog with chapter-mark carry (work.c:2518)."""
        pending_chap = 0
        while not self.die.is_set():
            buf = fifo_in.get(timeout=0.25)
            if buf is None:
                if fifo_in.closed:
                    break
                continue
            if buf.is_eof():
                for o in f.flush():
                    if pending_chap and not o.new_chap:
                        o.new_chap, pending_chap = pending_chap, 0
                    fifo_out.push(o)
                fifo_out.push(buf)
                break
            chap = buf.new_chap
            outs = f.work(buf)
            if chap and not any(o.new_chap for o in outs):
                # filter dropped/queued the chapter frame — carry mark forward
                if outs:
                    outs[0].new_chap = chap
                else:
                    pending_chap = chap
            for o in outs:
                if pending_chap and not o.new_chap:
                    o.new_chap, pending_chap = pending_chap, 0
                if not fifo_out.push(o):
                    break
        f.close()

    # ---- assembly ----

    def add_work(self, w: WorkObject):
        if w.fifo_in is None:
            t = _StageThread(lambda w=w: self._generator_loop(w), w.name)
        else:
            t = _StageThread(lambda w=w: self._work_loop(w), w.name)
        self.threads.append(t)

    def add_filter(self, f: FilterObject, fifo_in: Fifo, fifo_out: Fifo):
        t = _StageThread(
            lambda f=f, a=fifo_in, b=fifo_out: self._filter_loop(f, a, b), f.name)
        self.threads.append(t)

    def run(self, join_thread_index: int = -1):
        """Start all stages; join on the last (muxer) thread (work.c:2287)."""
        for t in self.threads:
            t.start()
        last = self.threads[join_thread_index]
        while last.is_alive():
            last.join(timeout=0.25)
            if self.die.is_set():
                break
            for t in self.threads:
                if t.exc is not None:
                    self.error = t.exc
                    self.stop()
                    break
        # drain remaining threads
        self.stop_fifos()
        for t in self.threads:
            t.join(timeout=5.0)
        for t in self.threads:
            if t.exc is not None and self.error is None:
                self.error = t.exc

    def stop(self):
        self.die.set()
        self.stop_fifos()

    def stop_fifos(self):
        for f in self.fifos:
            f.close()
