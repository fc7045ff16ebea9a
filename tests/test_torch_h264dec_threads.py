"""The port's native H.264 decoder keeps its picture state in each
decoder (``struct Dec``), so decoders on threads of one process share
nothing.  Four threads decode the same stream fifteen times each, a
CAVLC stream and a CABAC/High one: every decode must equal the serial
decode, and the serial planes must equal the JAX package's decoder.  Two
``do_job`` calls on threads over H.264 mp4 sources must write the files
of the same jobs run one after the other.  (The JAX package's decoder
keeps one global picture state; it is left as it is.)"""
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from handbrake_tpu.codecs.h264.native_decoder import \
    NativeH264Decoder as JNativeDecoder
from handbrake_tpu_torch import work
from handbrake_tpu_torch.codecs.h264 import encoder as tenc
from handbrake_tpu_torch.codecs.h264.native_decoder import NativeH264Decoder
from handbrake_tpu_torch.job import schema as S
from handbrake_tpu_torch.mux.mp4 import MP4Writer
from handbrake_tpu_torch.utils.synth import make_clip

W, H, N = 320, 192, 12
THREADS, REPS = 4, 15


def _stream(w, h, n, seed, **tools):
    enc = tenc.H264Encoder(tenc.EncoderConfig(width=w, height=h, qp=28,
                                              gop=60, **tools),
                           device="cpu")
    return [enc.encode_frame(*f) for f in make_clip(w, h, n, seed=seed)]


STREAMS = {
    "cavlc": dict(),
    "cabac-high": dict(deblock=True, cabac=True, transform8x8=True),
}


def _decode(dec, stream):
    return [f for au in stream for f in dec.decode(au)]


def _same(a, b) -> bool:
    return len(a) == len(b) and all(
        np.array_equal(p, q) for fa, fb in zip(a, b) for p, q in zip(fa, fb))


@pytest.mark.parametrize("name", list(STREAMS))
def test_threaded_decodes_equal_serial(name):
    stream = _stream(W, H, N, 5, **STREAMS[name])
    serial = _decode(NativeH264Decoder(), stream)
    assert len(serial) == N
    assert _same(serial, _decode(JNativeDecoder(), stream))
    start = threading.Barrier(THREADS)

    def worker(_k):
        start.wait()
        out = []
        for _ in range(REPS):
            try:
                out.append(_same(_decode(NativeH264Decoder(), stream),
                                 serial))
            except RuntimeError:
                out.append(False)
        return out

    with ThreadPoolExecutor(THREADS) as pool:
        results = [r for rs in pool.map(worker, range(THREADS)) for r in rs]
    assert len(results) == THREADS * REPS
    assert results.count(False) == 0, f"{results.count(False)} of " \
        f"{len(results)} threaded decodes differ from the serial decode"


def _mp4_source(path, seed):
    w = MP4Writer(path)
    t = w.add_video_track(codec="h264", width=96, height=64)
    for i, au in enumerate(_stream(96, 64, 8, seed, cabac=True,
                                   deblock=True, transform8x8=True)):
        w.write_sample(t, au, duration=3003, sync=i == 0, annexb=True)
    w.finalize()
    return path


def test_do_job_in_two_threads_equals_serial(tmp_path):
    srcs = [_mp4_source(str(tmp_path / f"src{k}.mp4"), 11 + k)
            for k in range(2)]

    def job(k, tag):
        out = str(tmp_path / f"{tag}{k}.mp4")
        j = S.Job(path=srcs[k], file=out, mux="mp4", vcodec="h264",
                  quality=28.0, encoder_profile="high",
                  encoder_options="keyint=4")
        work.do_job(j, device="cpu")
        with open(out, "rb") as f:
            return f.read()

    serial = [job(k, "serial") for k in range(2)]
    with ThreadPoolExecutor(2) as pool:
        threaded = list(pool.map(lambda k: job(k, "thread"), range(2)))
    assert serial[0] != serial[1]
    assert threaded == serial
