"""The reference's side of the catalog tests' comparisons, run in a spawned
child process (``torch_catalog.reference``), never in the pytest worker.

Each function drives the JAX package's libavcodec binding, its decoder
registry, its scan or its ``do_job``, and returns bytes, numpy arrays or
plain values; an exception it raises reaches the test.  The reference's
binding keeps per-process state that it finds by scanning memory and
then writes through (an AVFrame's channel-layout offset), so its calls
stay out of the worker, which goes on to run other test files.  This
module imports neither torch nor the port."""
import contextlib
import functools
import os
import tempfile

import numpy as np


def start():
    """The child's set-up, as ``tests/conftest.py`` and the port's tests
    make it in the worker: JAX on the CPU, the reference's device path,
    and one jitted H.264 analyzer a shape (the build functions are
    pure)."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.pop("HB_TPU_DISABLE_DEVICE", None)
    import jax
    jax.config.update("jax_platforms", "cpu")
    from handbrake_tpu.codecs.h264 import encoder_tpu
    for name in ("build_p_analyzer", "build_p_analyzer_batch"):
        setattr(encoder_tpu, name,
                functools.lru_cache(None)(getattr(encoder_tpu, name)))


@contextlib.contextmanager
def _library(hidden):
    """With `hidden`, the binding looks for the library in an empty
    directory with a fresh probe state, as on a machine without it."""
    if not hidden:
        yield
        return
    from handbrake_tpu.codecs import avcodec
    saved = avcodec._LIBDIR, avcodec._state
    with tempfile.TemporaryDirectory() as empty:
        avcodec._LIBDIR, avcodec._state = empty, {}
        try:
            yield
        finally:
            avcodec._LIBDIR, avcodec._state = saved


def job(fields, audio=(), hidden=False):
    """The reference's ``do_job`` of ``Job(**fields)`` with the audio
    tracks ``AudioJobTrack(**a)`` for each of `audio`: its stats and the
    bytes of the file it wrote."""
    from handbrake_tpu import work
    from handbrake_tpu.job import schema as JS
    j = JS.Job(**fields)
    j.audio = [JS.AudioJobTrack(**a) for a in audio]
    with _library(hidden):
        stats = work.do_job(j)
    with open(j.file, "rb") as f:
        return stats, f.read()


def scan(path, **kw):
    """The reference's ``scan_title`` of `path`, its previews (if kept)
    as numpy planes."""
    from handbrake_tpu.scan import scan_title
    t = scan_title(path, **kw)
    if "__previews__" in t.metadata:
        t.metadata["__previews__"] = [[np.asarray(p) for p in prev]
                                      for prev in t.metadata["__previews__"]]
    return t


def _frame(f):
    return f.pts, f.duration, f.stop, [np.asarray(p) for p in f.planes]


def decode(codec, extradata, buffers, flush=True):
    """The reference registry's decoder of `codec` fed ``Buffer(**b)``
    for each of `buffers`: the frames that each feed gave, as (pts,
    duration, stop, planes), then the flush's (None without `flush`),
    and the decoder's class name and whether it switched to
    libavcodec."""
    from handbrake_tpu.codecs import registry
    from handbrake_tpu.core.buffer import Buffer
    dec = registry.create_video_decoder(codec, extradata)
    fed = [[_frame(f) for f in dec.feed(Buffer(**b))] for b in buffers]
    tail = [_frame(f) for f in dec.flush()] if flush else None
    return fed, tail, type(dec).__name__, getattr(dec, "_is_fallback", None)


def video_packets(codec, w, h, frames, **kw):
    """The packets of the reference binding's `codec` encoder on
    `frames` ((y, u, v) each), flushed."""
    from handbrake_tpu.codecs import avcodec
    enc = avcodec.AVVideoEncoder(codec, w, h, **kw)
    pkts = []
    for f in frames:
        pkts += enc.encode(*f)
    return [p for p, _k in pkts + enc.flush()]
