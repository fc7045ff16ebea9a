#!/usr/bin/env python3
"""Where a job's time goes on one NVIDIA GPU: the job path's stages timed
by host clocks around their calls.

    python3 -m handbrake_tpu_torch.tools.profile_job

Runs the two jobs of ``chip_smoke.py``'s job phase, built by the helpers
below that the smoke script also uses, in a temporary directory: the
3840x2160 letterboxed y4m through the CLI with its default preset (scan,
autocrop, crop/scale to 1920x804, the framerate shaper; ``LETTERBOX_ARGV``)
and the unscaled 1920x1080 y4m through ``work.do_job``
(``unscaled_job``).  Each runs twice in one process, the first run to warm
it.  In the second run every stage call is timed: the y4m read of a
frame, decode+sync, the filter graph, within it the crop/scale filter
(split into the wait for the work already queued on the card, by a
synchronize before the call, and the call itself) and the framerate
shaper, bringing the planes to the host, ``begin_frame``,
``finish_frame``, the mux, and in a job with sound tracks the audio
decoders and chains.  The stages run in threads of their own, so
their times overlap; each is host wall time, device waits included.  A
third run of the letterboxed job under ``torch.profiler`` gives the
card's busy time (kernel and copy time summed) against that run's wall
time.  Prints the card's name and power limit and one JSON line.  Imports
nothing of JAX.
"""
from __future__ import annotations

import collections
import json
import os
import subprocess
import tempfile
import threading
import time

import numpy as np
import torch

from .. import work
from ..audio.chain import AudioChain
from ..cli.__main__ import main as cli_main
from ..codecs.h264.encoder import H264Encoder
from ..filters.cropscale import CropScaleFilter
from ..filters.graph import FilterGraph
from ..filters.rendersub import RenderSubFilter
from ..filters.vfr import VFRFilter
from ..job.schema import Job
from ..sources.raw import Y4MReader
from ..utils.synth import make_clip, write_y4m

N = 33
# the letterboxed source: 2.39:1 film (3840x1608) between black bars of
# 276 rows in a 3840x2160 frame, brought down to 1080p by the CLI's
# default preset, Fast 1080p30
JOB_W, JOB_H, JOB_BAR = 3840, 2160, 276
JOB_Q = 28              # the letterboxed job's -q
UNSCALED = (1920, 1080)
UNSCALED_Q = 26         # the unscaled job's quality


def letterbox_frames(n):
    """The letterboxed source's pictures, without their bars."""
    return make_clip(JOB_W, JOB_H - 2 * JOB_BAR, n)


def write_letterbox(path, frames):
    return write_y4m(path, frames, JOB_W, JOB_H, JOB_BAR)


def letterbox_argv(src, out):
    """The CLI's arguments for the letterboxed job (default preset and
    device)."""
    return ["-i", src, "-o", out, "-e", "h264", "-q", str(JOB_Q),
            "--encoder-profile", "high"]


def unscaled_job(src, out):
    """H.264 High at quality 26 into mp4, with no crop/scale filter."""
    return Job(path=src, file=out, mux="mp4", vcodec="h264",
               quality=float(UNSCALED_Q), encoder_profile="high")


class JobSpy:
    """Records the job and encoder that work.do_job builds, do_job's wall
    time, and the planes and qp of the first `keep` frames the encoder
    is given, by wrapping the port's work module for one drive.  For an
    encoder that codes a frame in one call (the HEVC and AV1 walkers) it
    also records each call's (IDR, host seconds) in ``walker``, with
    `recons` copies of the reconstruction planes after each call, and
    hands each call's access unit and encoder to `on_frame`."""

    def __init__(self, keep=0, recons=False, on_frame=None):
        self.job = self.enc = None
        self.seconds = 0.0
        self.keep = keep
        self.frames = []            # (y, u, v, qp) given to the encoder
        self.walker = []            # (is_idr, host s) a one-call frame
        self.keep_recons = recons
        self.recons = []            # (y, u, v) after each one-call frame
        self.on_frame = on_frame

    def _keep(self, y, u, v, qp):
        if len(self.frames) < self.keep:
            self.frames.append((np.array(y), np.array(u), np.array(v), qp))

    def __enter__(self):
        self._orig = (work.create_video_encoder, work.do_job)
        make_enc, run_job = self._orig

        def create_video_encoder(job, *a, **k):
            self.job, self.enc = job, make_enc(job, *a, **k)
            enc = self.enc
            if not hasattr(enc, "begin_frame"):
                code = enc.encode_frame

                def encode_frame(y, u, v, *a2, **k2):
                    self._keep(y, u, v, k2.get("qp"))
                    t0 = time.perf_counter()
                    au = code(y, u, v, *a2, **k2)
                    self.walker.append((enc.last_frame_was_idr,
                                        time.perf_counter() - t0))
                    if self.keep_recons:
                        self.recons.append(tuple(np.array(p) for p in (
                            enc.recon_y, enc.recon_u, enc.recon_v)))
                    if self.on_frame is not None:
                        self.on_frame(au, enc)
                    return au

                enc.encode_frame = encode_frame
                return enc
            begin = enc.begin_frame

            def begin_frame(y, u, v, *a2, **k2):
                self._keep(y, u, v, k2.get("qp"))
                return begin(y, u, v, *a2, **k2)

            enc.begin_frame = begin_frame
            return enc

        def do_job(*a, **k):
            t0 = time.perf_counter()
            try:
                return run_job(*a, **k)
            finally:
                self.seconds = time.perf_counter() - t0

        work.create_video_encoder, work.do_job = create_video_encoder, do_job
        return self

    def __exit__(self, *exc):
        work.create_video_encoder, work.do_job = self._orig

    def p_frames(self) -> int:
        """P frames the encoder analysed once (IDRs excluded)."""
        return sum(1 for i in range(self.enc.frame_idx)
                   if i % self.enc.cfg.gop)


class StageTimers:
    """Host wall time summed per stage call, by wrapping the stages'
    methods for the length of a `with` block."""

    METHODS = ((work._DecodeSyncStage, "work", "decode+sync"),
               (FilterGraph, "work", "filter graph"),
               (VFRFilter, "work", "framerate shaper"),
               (RenderSubFilter, "work", "render_sub"),
               (work._EncodeStage, "_planes", "planes to host"),
               (H264Encoder, "begin_frame", "begin_frame"),
               (H264Encoder, "finish_frame", "finish_frame"),
               (work._MuxStage, "work", "mux"),
               # audio (jobs with sound tracks): the decoders run on the
               # decode+sync thread, the chains on the filter+encode one
               (work._AacPacketDecoder, "feed", "audio decode"),
               (work._Ac3PacketDecoder, "feed", "audio decode"),
               (work._PcmDecoder, "feed", "audio decode"),
               (AudioChain, "process", "audio chain"),
               (AudioChain, "flush", "audio chain"))

    def __init__(self):
        self.sec = collections.defaultdict(float)
        self._lock = threading.Lock()

    def _add(self, key, dt):
        with self._lock:
            self.sec[key] += dt

    def _timed(self, fn, key):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self._add(key, time.perf_counter() - t0)
        return call

    def _timed_crop_scale(self, fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            t1 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                t2 = time.perf_counter()
                self._add("crop/scale: wait for queued work", t1 - t0)
                self._add("crop/scale: call", t2 - t1)
        return call

    def _timed_packets(self, fn):
        def packets(*a, **k):
            gen = fn(*a, **k)
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(gen)
                except StopIteration:
                    return
                finally:
                    self._add("y4m read", time.perf_counter() - t0)
                yield item
        return packets

    def __enter__(self):
        self._orig = [(cls, name, getattr(cls, name))
                      for cls, name, _ in self.METHODS]
        self._orig += [(Y4MReader, "packets", Y4MReader.packets),
                       (CropScaleFilter, "work", CropScaleFilter.work)]
        for cls, name, key in self.METHODS:
            setattr(cls, name, self._timed(getattr(cls, name), key))
        Y4MReader.packets = self._timed_packets(Y4MReader.packets)
        CropScaleFilter.work = self._timed_crop_scale(CropScaleFilter.work)
        return self

    def __exit__(self, *exc):
        for cls, name, fn in self._orig:
            setattr(cls, name, fn)


def _run(run):
    """(do_job's wall time, analyses re-run) of one drive."""
    with JobSpy() as spy:
        run()
        torch.cuda.synchronize()
    return spy.seconds, spy.enc.n_redo


def _busy_ms(run):
    """The card's kernel and copy time summed over one run, and do_job's
    wall time, in ms."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall, _ = _run(run)
    dev = sum(e.self_device_time_total for e in prof.key_averages())
    return dev / 1e3, wall * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_job: needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    out = {"card": card, "jobs": {}}
    with tempfile.TemporaryDirectory(prefix="profile_job_") as tmp:
        lb, flat = os.path.join(tmp, "lb.y4m"), os.path.join(tmp, "fl.y4m")
        write_letterbox(lb, letterbox_frames(N))
        write_y4m(flat, make_clip(*UNSCALED, N), *UNSCALED)
        lb_argv = letterbox_argv(lb, os.path.join(tmp, "lb.mp4"))

        def letterbox():
            if cli_main(lb_argv) != 0:
                raise RuntimeError("the letterboxed CLI job failed")

        def unscaled():
            work.do_job(unscaled_job(flat, os.path.join(tmp, "fl.mp4")))

        runs = {"letterbox_2160p_cli": letterbox,
                "unscaled_1080p_do_job": unscaled}
        for name, run in runs.items():
            _run(run)                       # warm-up
            with StageTimers() as st:
                wall, redo = _run(run)
            rec = {"wall_s": wall, "fps": N / wall, "reanalysed": redo,
                   "ms_per_frame": {k: v / N * 1e3
                                    for k, v in st.sec.items()}}
            print(f"{name} ({card}): do_job {N / wall:.2f} fps, {redo} "
                  f"re-analysed; ms per frame: " + ", ".join(
                      f"{k} {v:.2f}" for k, v in
                      rec["ms_per_frame"].items()), flush=True)
            out["jobs"][name] = rec
        dev, wall = _busy_ms(letterbox)
        out["letterbox_profiled"] = {"device_ms": dev, "wall_ms": wall,
                                     "busy_share": dev / wall}
        print(f"letterbox job under torch.profiler ({card}): device time "
              f"{dev:.1f} ms of {wall:.1f} ms of do_job, busy share "
              f"{dev / wall:.3f}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
