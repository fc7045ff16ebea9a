"""Multi-host job controller — the counterpart of
``handbrake_tpu/parallel/controller.py`` (the DCN scale-out layer,
SURVEY §2.8.5).

Generalizes the reference's out-of-process worker pattern (Windows
HandBrake.Worker: an HTTP job server with token auth, Program.cs:48-102)
into a distributed GOP-range dispatcher:

  * `WorkerServer` — one per host: a TCP JSON server that accepts
    {"cmd": "encode", "job": <job JSON>, "range": [a, b]} messages,
    runs the range through the REAL engine (work.do_job — decode, sync,
    filters, encode, mux all included), streams {"state": ...} progress
    lines back, and finishes with the encoded segment.
  * `Controller` — rank 0: splits the title into keyframe-aligned frame
    ranges (split_gops), dispatches one range per worker, aggregates the
    per-host frame counters into ONE hb_state-shaped dict, gathers the
    encoded segments in order and remuxes them into the destination
    (muxcommon interleave semantics preserved at rank 0).

Within each host, Job.gop_parallel can additionally shard over that
host's local chips (parallel/gop.py) — the {host × chip} mesh of
SURVEY §2.8.  Transport is line-delimited JSON over TCP with a shared
token (the Worker's HttpListener + token auth analog); segments travel
as base64 of the worker's finished mp4 (DCN moves bitstream, not
pixels).

In the port each ``WorkerServer`` runs its ranges on the device it was
given (``device=None``: the CUDA card).  ``Controller.run`` returns an
error, and writes no file, when a worker reports one, cannot be reached,
drops the connection before its segment, or codes another number of
frames than its range holds.
"""
from __future__ import annotations

import base64
import json
import os
import socket
import socketserver
import tempfile
import threading
import time


def _send(sock_file, obj):
    sock_file.write((json.dumps(obj) + "\n").encode())
    sock_file.flush()


class WorkerServer:
    """One encode worker per host (HandBrake.Worker Program.cs role)."""

    def __init__(self, host="127.0.0.1", port=0, token="hbtpu",
                 device=None):
        self.token = token
        self.device = device
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                for line in self.rfile:
                    try:
                        msg = json.loads(line)
                    except ValueError:
                        break
                    if msg.get("token") != outer.token:
                        _send(self.wfile, {"error": "bad token"})
                        break
                    cmd = msg.get("cmd")
                    if cmd == "ping":
                        _send(self.wfile, {"ok": True})
                    elif cmd == "encode":
                        outer._encode(self.wfile, msg)
                    elif cmd == "quit":
                        break

        self.srv = socketserver.ThreadingTCPServer((host, port), Handler)
        self.srv.daemon_threads = True
        self.port = self.srv.server_address[1]
        self._thread = threading.Thread(target=self.srv.serve_forever,
                                        daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self.srv.shutdown()
        self.srv.server_close()

    def _encode(self, wfile, msg):
        from ..job.schema import Job
        from ..work import do_job
        job = Job.from_json(msg["job"])
        a, b = msg["range"]
        job.range.type = "frame"
        job.range.start = a
        job.range.end = b
        fd, seg_path = tempfile.mkstemp(suffix=".mp4")
        os.close(fd)
        job.file = seg_path
        job.mux = "mp4"              # segments always travel as mp4;
                                     # rank 0 remuxes into the final
                                     # destination container

        n_range = b - a + 1

        class _State:
            progress = 0.0

            def update(self, **kw):
                if "progress" in kw:
                    _State.progress = float(kw["progress"])

        state = _State()
        done = threading.Event()

        def progress_pump():
            last = -1
            while not done.wait(0.05):
                n = int(_State.progress * n_range)
                if n != last:
                    _send(wfile, {"state": {"frames_out": n}})
                    last = n

        # periodic per-host counters (hb_get_state2 poll analog)
        pump = threading.Thread(target=progress_pump, daemon=True)
        pump.start()
        try:
            stats = do_job(job, state=state, device=self.device)
            done.set()
            pump.join(timeout=1)
            with open(seg_path, "rb") as f:
                data = f.read()
            _send(wfile, {"done": {"frames_out": stats.get("frames_out", 0),
                                   "bytes_out": stats.get("bytes_out", 0)},
                          "segment": base64.b64encode(data).decode()})
        except Exception as e:  # noqa: BLE001 — report, don't kill server
            done.set()
            _send(wfile, {"error": str(e)})
        finally:
            try:
                os.unlink(seg_path)
            except OSError:
                pass


class Controller:
    """Rank-0 dispatcher: job JSON in, per-host ranges out, one
    aggregated state dict + final muxed file back."""

    def __init__(self, workers, token="hbtpu"):
        """workers: [(host, port)] — one per encode host."""
        self.workers = workers
        self.token = token
        self.state = {"State": "IDLE"}

    def run(self, job_json: dict, n_frames: int) -> dict:
        from .gop import split_gops
        from ..job.schema import Job
        job = Job.from_json(job_json)
        dest = job.file
        n_hosts = len(self.workers)
        chunks = split_gops(n_frames, n_hosts)
        ranges = [(s + 1, s + ln) for s, ln in chunks]   # 1-based incl.
        totals = [0] * n_hosts
        segments: list = [None] * n_hosts
        errors: list = []
        self.state = {"State": "WORKING",
                      "Working": {"Progress": 0.0, "Hosts": n_hosts}}

        def talk(k):
            try:
                converse(k)
            except (OSError, ValueError) as e:
                errors.append((k, f"{type(e).__name__}: {e}"))

        def converse(k):
            host, port = self.workers[k]
            with socket.create_connection((host, port), timeout=60) as s:
                f = s.makefile("rwb")
                _send(f, {"cmd": "encode", "token": self.token,
                          "job": job_json, "range": list(ranges[k]),
                          "segment_id": k})
                for line in f:
                    msg = json.loads(line)
                    if "state" in msg:
                        totals[k] = msg["state"].get("frames_out", 0)
                        self._aggregate(totals, n_frames)
                    elif "done" in msg:
                        totals[k] = msg["done"]["frames_out"]
                        segments[k] = base64.b64decode(msg["segment"])
                        self._aggregate(totals, n_frames)
                        return
                    elif "error" in msg:
                        errors.append((k, msg["error"]))
                        return

        threads = [threading.Thread(target=talk, args=(k,))
                   for k in range(n_hosts)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        for k, (a, b) in enumerate(ranges):
            if errors:
                break
            if segments[k] is None:
                errors.append((k, "the worker closed the connection "
                                  "without a segment"))
            elif totals[k] != b - a + 1:
                errors.append((k, f"{totals[k]} frames coded of the "
                                  f"{b - a + 1} in range {a}-{b}"))
        if errors:
            errors.sort(key=lambda e: e[0])   # worker order, not finish order
            self.state = {"State": "WORKDONE", "Error": errors}
            return {"error": errors}
        self._mux_segments(segments, dest)
        self.state = {"State": "WORKDONE",
                      "Working": {"Progress": 1.0}}
        return {"frames_out": sum(totals), "wall_s": wall,
                "per_host": totals, "file": dest}

    def _aggregate(self, totals, n_frames):
        """Sum of per-host frame counters → one hb_state-shaped dict."""
        done = sum(totals)
        self.state = {"State": "WORKING",
                      "Working": {"Progress": done / max(1, n_frames),
                                  "FramesDone": done}}

    @staticmethod
    def _mux_segments(segments, dest):
        """Gather-to-rank-0 mux: demux each host's segment and rewrite
        one continuous container (muxcommon interleave preserved), now
        carrying EVERY track — video, audio, subtitles — with rebased
        timestamps, into an mp4 or mkv destination by extension."""
        from ..sources.mp4 import MP4Demuxer
        mkv_out = str(dest).lower().endswith((".mkv", ".webm"))
        if mkv_out:
            from ..mux.mkv import MKVWriter
            w = MKVWriter(dest)
        else:
            from ..mux.mp4 import MP4Writer
            w = MP4Writer(dest)
        tmap = {}                    # segment track idx → writer idx
        t_off = 0                    # 90 kHz rebase per segment
        pts_track = {}               # writer idx → running pts (mkv)
        for si, seg in enumerate(segments):
            fd, p = tempfile.mkstemp(suffix=".mp4")
            os.close(fd)
            with open(p, "wb") as f:
                f.write(seg)
            d = MP4Demuxer(p)
            if not tmap:
                for k, ti in enumerate(d.tracks):
                    if ti.kind == "video":
                        # the segments' pixel aspect (their pasp)
                        par = (ti.par_num, ti.par_den)
                        if mkv_out:
                            tmap[k] = w.add_video_track(
                                codec=ti.codec, width=ti.width,
                                height=ti.height, private=b"", par=par)
                        else:
                            tmap[k] = w.add_video_track(
                                codec=ti.codec, width=ti.width,
                                height=ti.height, extradata=ti.extradata,
                                par=par)
                    elif ti.kind == "audio":
                        if mkv_out:
                            tmap[k] = w.add_audio_track(
                                codec=ti.codec,
                                sample_rate=ti.sample_rate,
                                channels=ti.channels,
                                private=ti.extradata,
                                language=ti.language)
                        else:
                            tmap[k] = w.add_audio_track(
                                codec=ti.codec,
                                sample_rate=ti.sample_rate,
                                channels=ti.channels,
                                extradata=ti.extradata,
                                language=ti.language)
                    else:
                        tmap[k] = w.add_subtitle_track(
                            codec=ti.codec, language=ti.language)
            seg_dur = 0
            for trk, b in d.packets():
                if trk not in tmap:
                    continue
                ti = d.tracks[trk]
                dur = int(b.duration or (3003 if ti.kind == "video"
                                         else 0))
                data = bytes(b.data)
                if mkv_out:
                    pts = t_off + (b.pts or 0)
                    w.write_sample(tmap[trk], data, pts_90k=pts,
                                   duration_90k=dur,
                                   sync=bool(b.frametype)
                                   or ti.kind != "video",
                                   annexb=(ti.kind == "video"
                                           and ti.codec in ("h264",
                                                            "hevc")))
                else:
                    tscale = w.tracks[tmap[trk]].timescale
                    w.write_sample(tmap[trk], data,
                                   duration=int(dur * tscale // 90000)
                                   if ti.kind == "audio" else dur,
                                   sync=bool(b.frametype)
                                   or ti.kind != "video",
                                   annexb=(ti.kind == "video"
                                           and ti.codec in ("h264",
                                                            "hevc")))
                if ti.kind == "video":
                    seg_dur += dur
            t_off += seg_dur
            d.close()
            os.unlink(p)
        w.finalize()
