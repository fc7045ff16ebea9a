"""The port's multi-host controller (``parallel/controller.py``): two
``WorkerServer(device="cpu")``s in this process and a ``Controller`` over
them, on ``tests/test_controller.py::test_controller_remux_carries_audio_and_mkv``'s
source (an H.264 mkv with a PCM track, to mkv with AAC).  The remuxed
file must equal the reference's controller output byte for byte; the
reference's is made from the same ranges run one after the other through
its ``do_job`` and its ``Controller._mux_segments`` (its two workers in
one process share its decoder's global state).  The state stream
aggregates the workers' counters; a bad token, a failing job and an
unreachable worker make ``run`` return an error and write no file."""
import functools
import os

import numpy as np
import pytest

from handbrake_tpu import work as jwork
from handbrake_tpu.codecs.h264 import encoder_tpu
from handbrake_tpu.job import schema as JS
from handbrake_tpu.parallel.controller import Controller as JController
from handbrake_tpu.parallel.gop import split_gops as j_split_gops
from handbrake_tpu_torch.codecs.h264.encoder import EncoderConfig, H264Encoder
from handbrake_tpu_torch.mux.mkv import MKVWriter
from handbrake_tpu_torch.parallel.controller import Controller, WorkerServer
from handbrake_tpu_torch.sources.mkv import MKVDemuxer

W, H, N = 64, 48, 16


@pytest.fixture(scope="module", autouse=True)
def _reference_device_path():
    """The reference encodes on its device path, as the port does (some
    of its tests leave HB_TPU_DISABLE_DEVICE=1 set); its encoders of one
    shape share one jitted analyzer."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("HB_TPU_DISABLE_DEVICE", raising=False)
        for name in ("build_p_analyzer", "build_p_analyzer_batch"):
            mp.setattr(encoder_tpu, name,
                       functools.lru_cache(None)(getattr(encoder_tpu, name)))
        yield


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ctl") / "src.mkv")
    enc = H264Encoder(EncoderConfig(width=W, height=H, qp=30, gop=N),
                      device="cpu")
    w = MKVWriter(path)
    vi = w.add_video_track(codec="h264", width=W, height=H, fps=30.0)
    ai = w.add_audio_track(codec="pcm_s16le", sample_rate=48000,
                           channels=2)
    base = (np.add.outer(np.arange(H), np.arange(W)) * 3 % 256).astype(
        np.uint8)
    t = np.arange(4800) / 48000.0
    tone = (np.clip(np.stack([np.sin(2 * np.pi * 440 * t)] * 2, 1), -1, 1)
            * 12000).astype("<i2").tobytes()
    for i in range(N):
        au = enc.encode_frame(np.roll(base, i, 1),
                              np.full((H // 2, W // 2), 110, np.uint8),
                              np.full((H // 2, W // 2), 60, np.uint8))
        w.write_sample(vi, au, pts_90k=i * 3000, duration_90k=3000,
                       sync=(i == 0), annexb=True)
    for k in range(6):
        w.write_sample(ai, tone, pts_90k=k * 9000, duration_90k=9000)
    w.finalize()
    return path


def _job_json(src, out, encoder="h264"):
    return {"Source": {"Path": src},
            "Destination": {"Mux": "mkv", "File": out},
            "Video": {"Encoder": encoder, "Quality": 30.0},
            "Audio": {"AudioList": [
                {"Track": 1, "Encoder": "aac", "Mixdown": "stereo",
                 "Bitrate": 128}]}}


def _reference_output(job_json, dest, tmp_path):
    """The reference Controller's file: each worker's range through its
    do_job to an mp4 segment, as its WorkerServer runs it, then its
    rank-0 remux."""
    segs = []
    for k, (s, ln) in enumerate(j_split_gops(N, 2)):
        job = JS.Job.from_json(job_json)
        job.range.type, job.range.start, job.range.end = "frame", s + 1, \
            s + ln
        job.file = str(tmp_path / f"seg{k}.mp4")
        job.mux = "mp4"
        jwork.do_job(job)
        with open(job.file, "rb") as f:
            segs.append(f.read())
    JController._mux_segments(segs, dest)


class _Recording(Controller):
    def _aggregate(self, totals, n_frames):
        super()._aggregate(totals, n_frames)
        self.seen = getattr(self, "seen", []) + [self.state["Working"]
                                                 ["FramesDone"]]


def test_two_workers_remux_equals_reference(src, tmp_path):
    out = str(tmp_path / "dist.mkv")
    workers = [WorkerServer(token="tk", device="cpu").start()
               for _ in range(2)]
    try:
        ctl = _Recording([("127.0.0.1", s.port) for s in workers],
                         token="tk")
        res = ctl.run(_job_json(src, out), n_frames=N)
    finally:
        for s in workers:
            s.stop()
    assert not res.get("error"), res
    assert res["frames_out"] == N and res["per_host"] == [N // 2, N // 2]
    assert ctl.state == {"State": "WORKDONE", "Working": {"Progress": 1.0}}
    assert ctl.seen == sorted(ctl.seen) and ctl.seen[-1] == N
    ref = str(tmp_path / "ref.mkv")
    _reference_output(_job_json(src, ref), ref, tmp_path)
    with open(out, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    d = MKVDemuxer(out)
    kinds = [t.kind for t in d.tracks]
    assert kinds == ["video", "audio"] and d.tracks[1].codec == "aac"
    counts = {}
    for trk, _p in d.packets():
        counts[trk] = counts.get(trk, 0) + 1
    d.close()
    assert counts[0] == N and counts[1] > 8


def test_bad_token_refused(src, tmp_path):
    srv = WorkerServer(token="secret", device="cpu").start()
    try:
        out = str(tmp_path / "x.mkv")
        res = Controller([("127.0.0.1", srv.port)], token="wrong").run(
            _job_json(src, out), n_frames=N)
    finally:
        srv.stop()
    assert res["error"] == [(0, "bad token")]
    assert not os.path.exists(out)


def test_failed_worker_fails_the_run(src, tmp_path):
    """A job a worker cannot run, and a worker nobody listens for: run
    returns the errors and writes no file short of frames."""
    srv = WorkerServer(token="tk", device="cpu").start()
    out = str(tmp_path / "f.mkv")
    try:
        res = Controller([("127.0.0.1", srv.port)] * 2, token="tk").run(
            _job_json(src, out, encoder="no-such-codec"), n_frames=N)
    finally:
        srv.stop()
    assert [k for k, _e in res["error"]] == [0, 1]
    assert not os.path.exists(out)
    srv = WorkerServer(token="tk", device="cpu").start()
    dead = WorkerServer(token="tk", device="cpu")
    dead_port = dead.port
    dead.srv.server_close()
    try:
        res = Controller([("127.0.0.1", srv.port),
                          ("127.0.0.1", dead_port)], token="tk").run(
            _job_json(src, out), n_frames=N)
    finally:
        srv.stop()
    assert [k for k, _e in res["error"]] == [1]
    assert not os.path.exists(out)
