"""Handle & lifecycle — the public API surface (reference: libhb/hb.c
hb_init/hb_scan/hb_add/hb_start/hb_get_state2/hb_stop/hb_close +
hb_json.c's hb_add_json). Multiple Handle instances may coexist
(instance-parallelism, hb.c:2378).

Threading model mirrors the reference: scan and work run on their own
threads; the caller polls ``get_state()`` (hb_get_state2) for a
reference-shaped state dict. Cancellation is cooperative via a die event
(work.c:2439); pause stalls between jobs/frames via an event the work
loop waits on.

The counterpart of ``handbrake_tpu/hb.py``: a Handle takes ``device``
(None: the CUDA card; "cpu" runs on the CPU) and hands it to every job
and preview it runs.  A scan or a job that fails keeps its exception in
``scan_error`` or ``work_exception`` (an unported filter raises
NotImplementedError; a libavcodec catalog codec where the library is
missing, ValueError or WorkError naming what was not found).  Under torchrun the jobs of every
Handle on rank 0 share the process's world (``parallel/mesh.py``), which
hands out one work item at a time, so jobs on threads never interleave
their items.
"""
from __future__ import annotations

import json
import threading
from typing import List, Optional

from . import scan as scanmod
from . import work as workmod
from .core import state as St
from .core.state import State
from .job.schema import Job
from .job.title import Title, title_set_to_json
from .utils.logging import log, error

_instance_counter = [0]


class Handle:
    def __init__(self, verbose: int = 0, device=None):
        _instance_counter[0] += 1
        self.device = device
        self.scan_error: Optional[Exception] = None
        self.instance_id = _instance_counter[0]
        self.verbose = verbose
        self.state = State()
        self.titles: List[Title] = []
        self.jobs: List[Job] = []
        self._scan_thread: Optional[threading.Thread] = None
        self._work_thread: Optional[threading.Thread] = None
        self._die = threading.Event()
        self._paused = threading.Event()
        self._paused.set()          # set = running, cleared = paused
        self.work_error = St.ERROR_NONE
        self.work_exception: Optional[Exception] = None

    # -- scan -----------------------------------------------------------------
    def scan(self, path: str, title_index: int = 0,
             preview_count: int = 10, keep_previews: bool = True):
        """hb_scan: spawn the scan thread (scan.c:89)."""
        self.state.set(St.SCANNING, progress=0.0, title_count=0)
        self.scan_error = None

        def _scan():
            try:
                self.titles = scanmod.scan(path, title_index,
                                           preview_count,
                                           keep_previews=keep_previews)
            except Exception as e:   # noqa: BLE001 — scan errors → no titles
                error(f"scan failed: {e}")
                self.titles = []
                self.scan_error = e
            self.state.set(St.SCANDONE,
                           title_count=len(self.titles))

        self._scan_thread = threading.Thread(
            target=_scan, name=f"scan:{self.instance_id}", daemon=True)
        self._scan_thread.start()

    def scan_wait(self, timeout: Optional[float] = None) -> List[Title]:
        if self._scan_thread is not None:
            self._scan_thread.join(timeout)
        return self.titles

    def get_title_set_json(self) -> str:
        return json.dumps(title_set_to_json(self.titles))

    # -- previews -------------------------------------------------------------
    def get_preview(self, job, preview_idx: int):
        """hb_get_preview3 (hb.c:1065): render stored scan preview
        ``preview_idx`` through the job's filter chain → (y, u, v) planes
        at the job's output geometry, as numpy."""
        from fractions import Fraction

        from .core.buffer import PIX_FMTS, Buffer, Geometry
        from .filters import FilterGraph, FilterInit

        if isinstance(job, str):
            job = Job.from_json(json.loads(job))
        elif isinstance(job, dict):
            job = Job.from_json(job)
        titles = [t for t in self.titles if t.index == job.title] \
            or self.titles[:1]
        if not titles:
            raise ValueError("no scanned title")
        t = titles[0]
        previews = t.metadata.get("__previews__") or []
        if not previews:
            raise ValueError("no stored previews (scan with keep_previews)")
        y, u, v = previews[min(preview_idx, len(previews) - 1)]
        fi = FilterInit(
            geometry=Geometry(t.width, t.height, t.par_num, t.par_den),
            pix_fmt=PIX_FMTS.get("yuv420p"),
            vrate=Fraction(t.vrate_num, t.vrate_den), device=self.device)
        filter_list = [{"ID": f.id, "Settings": f.settings}
                       for f in job.filters]
        graph = FilterGraph(filter_list, fi)
        dur = 90000 * t.vrate_den // max(1, t.vrate_num)
        buf = Buffer(planes=[y.copy(), u.copy(), v.copy()],
                     track_kind="video", pts=0, duration=dur)
        buf.pix_fmt = fi.pix_fmt
        buf.stop = dur
        outs = graph.work(buf)
        outs += graph.flush()
        graph.close()
        if not outs:
            raise ValueError("filter chain produced no preview frame")
        return tuple(workmod.to_host(p) for p in outs[0].planes)

    # -- queue ----------------------------------------------------------------
    def add(self, job: Job):
        """hb_add: snapshot the job into the queue."""
        self.jobs.append(job.clone())

    def add_json(self, job_json) -> int:
        """hb_add_json: JSON dict/string → queued Job."""
        j = Job.from_json(job_json)
        self.add(j)
        return len(self.jobs)

    # -- work -----------------------------------------------------------------
    def start(self):
        """hb_start: spawn the work thread over the queued jobs."""
        self._die.clear()
        self.work_error = St.ERROR_NONE
        self.work_exception = None
        jobs, self.jobs = self.jobs, []

        def _work():
            err = St.ERROR_NONE
            for job in jobs:
                if self._die.is_set():
                    err = St.ERROR_CANCELED
                    break
                passes = setup_passes(job)
                for pi, p in enumerate(passes):
                    if self._die.is_set():
                        err = St.ERROR_CANCELED
                        break
                    self.state.set(St.WORKING, progress=0.0,
                                   pass_id=p.pass_id, pass_=pi + 1,
                                   pass_count=len(passes),
                                   sequence_id=job.sequence_id)
                    try:
                        self._paused.wait()
                        stats = workmod.do_job(p, state=self.state,
                                               die=self._die,
                                               pause=self._paused,
                                               device=self.device)
                        job.interjob.update(p.interjob)
                        log(f"pass {pi + 1}/{len(passes)} done: {stats}")
                    except Exception as e:  # noqa: BLE001 — job errors → state
                        error(f"job failed: {e}")
                        self.work_exception = e
                        err = St.ERROR_UNKNOWN
                        break
            self.state.set(St.WORKDONE, error=err)
            self.work_error = err

        self._work_thread = threading.Thread(
            target=_work, name=f"work:{self.instance_id}", daemon=True)
        self._work_thread.start()

    def work_wait(self, timeout: Optional[float] = None) -> int:
        if self._work_thread is not None:
            self._work_thread.join(timeout)
        return self.work_error

    # -- control ---------------------------------------------------------------
    def pause(self):
        self._paused.clear()
        self.state.set(St.PAUSED)

    def resume(self):
        self._paused.set()
        self.state.set(St.WORKING)

    def stop(self):
        """hb_stop: cooperative cancel."""
        self._die.set()
        self._paused.set()

    def close(self):
        self.stop()
        for t in (self._scan_thread, self._work_thread):
            if t is not None:
                t.join(timeout=5.0)

    # -- state -----------------------------------------------------------------
    def get_state(self) -> dict:
        return self.state.get()


def setup_passes(job: Job) -> List[Job]:
    """hb_job_setup_passes (hb.c:1945): expand multipass into
    [analysis pass][final pass]; subtitle-scan pass when Search is on."""
    passes = []
    if job.subtitle_search.get("Enable"):
        p = job.clone()
        p.pass_id = -1
        passes.append(p)
    if job.multipass and job.vbitrate:
        p1 = job.clone()
        p1.pass_id = 1
        p1.pass_count = 2
        passes.append(p1)
        p2 = job.clone()
        p2.pass_id = 2
        p2.pass_count = 2
        passes.append(p2)
    else:
        p = job.clone()
        p.pass_id = 0
        passes.append(p)
    # share one interjob dict across passes (hb_interjob_t analog)
    shared = job.interjob
    for p in passes:
        p.interjob = shared
    return passes
