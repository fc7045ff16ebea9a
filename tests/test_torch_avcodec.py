"""The port's libavcodec binding (``handbrake_tpu_torch/codecs/avcodec.py``)
and ``utils/quality.py`` against the JAX package's: the copies with their
listed replacements, where the library is looked for and what is said
when it is not there, and the binding's repaired faults beside the
reference's behaviour (VP8's encoder name, VP9's rate at a quality, the
decoder's pts behind B-frames).  The reference's encoders and decoders
run in a child process (``torch_catalog.reference``)."""
import os

import numpy as np
import pytest

import handbrake_tpu
import handbrake_tpu_torch
import torch_catalog_ref as ref_side
from handbrake_tpu_torch.codecs import avcodec as av
from handbrake_tpu_torch.codecs import registry
from handbrake_tpu_torch.core.buffer import Buffer
from torch_catalog import FRAME, H, N, W, frames, hide, needs_libavcodec, \
    reference

_LOAD = (
    '''    try:
        avutil = C.CDLL(os.path.join(_LIBDIR, "libavutil.so.57"),
                        mode=C.RTLD_GLOBAL)
        avcodec = C.CDLL(os.path.join(_LIBDIR, "libavcodec.so.59"),
                         mode=C.RTLD_GLOBAL)
    except OSError:
        avutil = avcodec = None
''',
    '''    # the struct offsets below are probed for these two majors only: a
    # library of another major is refused by name, never guessed at
    avutil = avcodec = None
    _state["missing"] = _absent()
    if not _state["missing"]:
        try:
            avutil = C.CDLL(os.path.join(_LIBDIR, _SONAMES[0]),
                            mode=C.RTLD_GLOBAL)
            avcodec = C.CDLL(os.path.join(_LIBDIR, _SONAMES[1]),
                             mode=C.RTLD_GLOBAL)
        except OSError as e:
            avutil = avcodec = None
            _state["missing"] = f"{_SONAMES[1]} does not load: {e}"
''')
_MISSING = (
    '''def available() -> bool:
    return _libs()[1] is not None
''',
    '''def available() -> bool:
    return _libs()[1] is not None


_SONAMES = ("libavutil.so.57", "libavcodec.so.59")


def _absent() -> str:
    """Why the two libraries cannot be loaded from _LIBDIR ("" if they
    are there)."""
    gone = [n for n in _SONAMES
            if not os.path.exists(os.path.join(_LIBDIR, n))]
    if not gone:
        return ""
    names = os.listdir(_LIBDIR) if os.path.isdir(_LIBDIR) else []
    other = sorted(n for n in names if n.startswith("libavcodec.so.")
                   and n.count(".") == 2 and n != _SONAMES[1])
    if _SONAMES[1] in gone and other:
        return (f"found {other[0]} in {_LIBDIR}; this binding's struct "
                f"offsets are for .59")
    return f"{' and '.join(gone)} not found in {_LIBDIR}"


def missing() -> str:
    """What was not found where available() is False, else ""."""
    _libs()
    return _state.get("missing", "")


def require(what: str, exc=RuntimeError):
    """Raise exc naming `what` and what was not found, unless the
    library loads."""
    if not available():
        raise exc(f"{what} needs libavcodec, which is missing "
                  f"({missing()})")
''')
_VP8 = ('''    "vp9": ("libvpx-vp9", "vp9"),
''', '''    "vp9": ("libvpx-vp9", "vp9"),
    "vp8": ("libvpx", "vp8"),
''')
_VP9_RATE = (
    '''        elif quality is not None and name == "libvpx-vp9":
            all_opts.setdefault("crf", quality)
''',
    '''        elif quality is not None and name in ("libvpx-vp9", "libvpx"):
            # constant quality: without b = 0 libvpx keeps the context's
            # default 200 kb/s and runs constrained-quality
            all_opts.setdefault("crf", quality)
            all_opts.setdefault("b", 0)
''')


_RECV_PTS = (
    '''            ints = f.ints()
            w = ints[_Frame.WIDTH // 4]
''',
    '''            ints = f.ints()
            pts = C.cast(f.ptr + _frame_pts_off(),
                         C.POINTER(C.c_longlong)).contents.value
            w = ints[_Frame.WIDTH // 4]
''')
_DECODE_PTS = (
    '''            out.append((plane(0, h, w),
                        plane(1, (h + 1) // 2, (w + 1) // 2),
                        plane(2, (h + 1) // 2, (w + 1) // 2)))

    def decode(self, packet: bytes) -> list:
        _, a = _libs()
        out: list = []
        with _lock:
            pkt = _new_packet(bytes(packet))
''',
    '''            out.append(((plane(0, h, w),
                         plane(1, (h + 1) // 2, (w + 1) // 2),
                         plane(2, (h + 1) // 2, (w + 1) // 2)),
                        None if pts == AV_NOPTS_VALUE else pts))

    def decode(self, packet: bytes, pts=None) -> list:
        """One packet, with its pts, in; [((y, u, v), pts)] out, each
        frame with its own pts (a frame that the decoder held back keeps
        the pts of the packet it came in)."""
        _, a = _libs()
        out: list = []
        with _lock:
            pkt = _new_packet(bytes(packet))
            C.cast(pkt + _PKT_PTS, C.POINTER(C.c_longlong)).contents.value \\
                = AV_NOPTS_VALUE if pts is None else int(pts)
''')
_PTS_PROBE = ("class AVVideoDecoder:", '''AV_NOPTS_VALUE = -(1 << 63)
_PKT_PTS = 8          # AVPacket.pts (classic layout: buf@0, pts@8, dts@16)


def _struct_bytes(ptr) -> int:
    """The bytes that the allocator gave the struct at `ptr` (at least
    its size): a probe reads and writes no further."""
    libc = C.CDLL(None)
    libc.malloc_usable_size.restype = C.c_size_t
    libc.malloc_usable_size.argtypes = [C.c_void_p]
    return libc.malloc_usable_size(C.c_void_p(ptr))


def _frame_pts_off():
    """AVFrame.pts's offset: decode two mpeg4 frames sent with two marker
    pts and keep the int64 slots of the frame that hold each one's
    marker, the first of them (best_effort_timestamp holds it too,
    further on)."""
    if "frame_pts" in _state:
        return _state["frame_pts"]
    marks = (0x5EED0001A1, 0x5EED0002B2)
    with _lock:
        enc = AVVideoEncoder("mpeg4", 64, 48, opts={"g": 1})
        z = np.zeros((24, 32), np.uint8)
        pkts = []
        for i in range(2):
            pkts += enc.encode(np.full((48, 64), 60 * i, np.uint8), z, z)
        pkts += enc.flush()
        _, a = _libs()
        dec = AVVideoDecoder("mpeg4", extradata=enc.extradata)
        hits = []

        def scan():
            while a.avcodec_receive_frame(C.c_void_p(dec.ctx),
                                          C.c_void_p(dec.frame.ptr)) >= 0:
                n = _struct_bytes(dec.frame.ptr) // 8
                slots = C.cast(dec.frame.ptr,
                               C.POINTER(C.c_longlong * n)).contents
                hits.append({i * 8 for i in range(n) if slots[i] in marks})
        for (data, _k), mark in zip(pkts, marks):
            pkt = _new_packet(data)
            C.cast(pkt + _PKT_PTS, C.POINTER(C.c_longlong)).contents.value \\
                = mark
            a.avcodec_send_packet(C.c_void_p(dec.ctx), C.c_void_p(pkt))
            a.av_packet_unref(C.c_void_p(pkt))
            scan()
        a.avcodec_send_packet(C.c_void_p(dec.ctx), None)
        scan()
        common = set.intersection(*hits) if len(hits) == 2 else set()
        if not common:
            raise RuntimeError("avcodec: frame pts probe failed")
        _state["frame_pts"] = min(common)
    return _state["frame_pts"]


''' + "class AVVideoDecoder:")
_LAYOUT_SCAN = (
    '''    for i in range(30, 190):
''',
    '''    # a pattern past the struct is heap that the frame does not own: the
    # encoder would write a layout there (a crash, now and then)
    for i in range(30, min(190, _struct_bytes(frame_ptr) // 4 - 3)):
''')


def _replacements(rel):
    if rel == "utils/quality.py":
        return ()
    return (_LOAD, _MISSING, _VP8, _VP9_RATE, _RECV_PTS, _DECODE_PTS,
            _PTS_PROBE, _LAYOUT_SCAN)


@pytest.mark.parametrize("rel", ["codecs/avcodec.py", "utils/quality.py"])
def test_copy_equals_original(rel):
    """Each copy is its original with the listed replacements (the
    import of ``_bootstrap_frame_probe`` is the same relative line, which
    reaches the port's ``audio/aac.py``)."""
    with open(os.path.join(os.path.dirname(handbrake_tpu_torch.__file__),
                           rel)) as f:
        got = f.read()
    with open(os.path.join(os.path.dirname(handbrake_tpu.__file__),
                           rel)) as f:
        want = f.read()
    for old, new in _replacements(rel):
        assert want.count(old) == 1 and got.count(new) == 1, old[:60]
        want = want.replace(old, new)
    assert got == want


def test_missing_library_named(monkeypatch, tmp_path):
    hide(monkeypatch, tmp_path)
    assert not av.available()
    assert av.missing() == (f"libavutil.so.57 and libavcodec.so.59 not "
                            f"found in {tmp_path / 'no_libavcodec'}")
    with pytest.raises(RuntimeError, match="libavcodec unavailable"):
        av.AVAudioEncoder("libopus")


def test_other_major_refused_by_name(monkeypatch, tmp_path):
    """A libavcodec of another major is named and not loaded: the
    binding's offsets are probed for .59 only."""
    d = tmp_path / "lib"
    d.mkdir()
    for n in ("libavutil.so.57", "libavcodec.so.60", "libavcodec.so.60.3"):
        (d / n).write_bytes(b"")
    monkeypatch.setattr(av, "_LIBDIR", str(d))
    monkeypatch.setattr(av, "_state", {})
    assert not av.available()
    assert av.missing() == (f"found libavcodec.so.60 in {d}; this "
                            f"binding's struct offsets are for .59")


@needs_libavcodec
def test_present_library_says_nothing_missing():
    assert av.available() and av.missing() == ""


@needs_libavcodec
def test_vp8_encoder_named(reference):
    """``vp8`` maps to libavcodec's ``libvpx``; the reference asks for an
    encoder named ``vp8`` and gets none."""
    enc = av.AVVideoEncoder("vp8", W, H, quality=20)
    pkts = []
    for f in frames():
        pkts += enc.encode(*f)
    pkts += enc.flush()
    assert len(pkts) == N and pkts[0][1]
    dec = av.AVVideoDecoder("vp8")
    assert len([f for p, _k in pkts for f in dec.decode(p)]
               + dec.flush()) == N
    with pytest.raises(RuntimeError, match="no encoder vp8"):
        reference(ref_side.video_packets, "vp8", W, H, [], quality=20)


VP9_OPTS = {"lag-in-frames": 0, "cpu-used": 4, "deadline": "good"}


def _vp9_bytes(quality):
    enc = av.AVVideoEncoder("vp9", W, H, quality=quality, opts=VP9_OPTS)
    pkts = []
    for f in frames(seed=3, n=16):
        pkts += enc.encode(*f)
    return [p for p, _k in pkts + enc.flush()]


def _ref_vp9_bytes(reference, quality, opts=None):
    """The reference's encoder, driven with VP9_OPTS and `opts`."""
    return reference(ref_side.video_packets, "vp9", W, H,
                     frames(seed=3, n=16), quality=quality,
                     opts=dict(VP9_OPTS, **(opts or {})))


@needs_libavcodec
def test_vp9_quality_is_constant_quality(reference):
    """A quality sets crf and b = 0, so libvpx runs constant quality:
    the packets equal the reference's encoder driven with
    ``opts={"b": 0}``, and the stream shrinks as the crf grows.  The
    reference's default run gives the same bytes on libavcodec 59: its
    libvpx wrappers default ``b`` to 0 (the codec's own defaults), so
    the 200 kb/s cap that the reference's code would keep does not
    bind there; the port sets b = 0 itself and does not rely on it."""
    sizes = []
    for q in (4, 10, 20):
        got = _vp9_bytes(q)
        assert got == _ref_vp9_bytes(reference, q, {"b": 0})
        assert got == _ref_vp9_bytes(reference, q)
        sizes.append(sum(map(len, got)))
    print(f"vp9 at q 4, 10, 20: {sizes} bytes for 16 frames")
    assert sizes[0] > sizes[1] > sizes[2]


def _bframe_mpeg4():
    """An MPEG-4 ASP stream with 2 B-frames (packets per frame
    [0, 0, 1, ...], two at the flush) and each packet's display
    index, read from its VOP type."""
    enc = av.AVVideoEncoder("mpeg4", W, H, bit_rate=400000,
                            opts={"bf": 2, "g": N})
    pkts = []
    for f in frames(seed=3):
        pkts += enc.encode(*f)
    pkts += enc.flush()
    pkts = [p for p, _k in pkts]
    disp, nxt, held = [], 0, None
    for i, p in enumerate(pkts):
        j = p.find(b"\x00\x00\x01\xb6")
        if p[j + 4] >> 6 == 2:
            disp.append((i, nxt))
            nxt += 1
        else:
            if held is not None:
                disp.append((held, nxt))
                nxt += 1
            held = i
    disp.append((held, nxt))
    order = [d for _i, d in sorted(disp)]
    return pkts, order, enc.extradata


@needs_libavcodec
def test_decoder_pts_behind_bframes(reference):
    """Each frame comes out with its own packet's (display) pts, in
    order, the last one included; the reference stamps each with the
    packet fed when it came out, a decode-order pts, and the last with
    none."""
    pkts, order, xd = _bframe_mpeg4()
    assert order != sorted(order)
    got = []
    dec = registry.create_video_decoder("mpeg4", xd)
    buffers = [dict(data=p, pts=d * FRAME, duration=FRAME)
               for p, d in zip(pkts, order)]
    for b in buffers:
        got += dec.feed(Buffer(**b))
    got += dec.flush()
    fed, tail, _name, _fb = reference(ref_side.decode, "mpeg4", xd, buffers)
    want = [f for out in fed for f in out] + tail
    assert [f.pts for f in got] == [i * FRAME for i in range(N)]
    assert all(f.duration == FRAME for f in got)
    jpts = [pts for pts, _d, _s, _p in want]
    assert jpts[-1] is None and jpts[:-1] == [d * FRAME for d in order[1:]]
    for a, (_pts, _d, _s, planes) in zip(got, want):
        assert all(np.array_equal(p, q) for p, q in zip(a.planes, planes))


def test_fallback_decoder_forgets_packets_never_out(monkeypatch):
    """A packet whose frame never comes out (an invisible VP8/VP9 alt-ref
    outside a superframe, a frame the decoder drops) is forgotten once a
    later frame is out, so the decoder keeps no packets for the whole
    title; the frames keep their own packets' timing."""
    class Inner:                  # every third packet shows no frame
        def __init__(self, *a, **k):
            pass

        def decode(self, data, pts):
            y = np.zeros((4, 4), np.uint8)
            uv = np.zeros((2, 2), np.uint8)
            return [] if pts % 3 == 1 else [((y, uv, uv), pts)]

        def flush(self):
            return []
    monkeypatch.setattr(av, "available", lambda: True)
    monkeypatch.setattr(av, "AVVideoDecoder", Inner)
    dec = registry.AVFallbackVideoDecoder("vp9")
    got = []
    for i in range(30):
        got += dec.feed(Buffer(data=b"x", pts=i, duration=7))
        assert len(dec._fed) <= 1
    assert [f.pts for f in got] == [i for i in range(30) if i % 3 != 1]
    assert all(f.duration == 7 for f in got)


@needs_libavcodec
def test_decoder_pts_without_bframes_equal_reference(reference):
    """Without B-frames each frame comes out on its own packet, and the
    two packages' frames carry the same timing."""
    enc = av.AVVideoEncoder("mpeg4", W, H, bit_rate=400000)
    pkts = [p for f in frames() for p, _k in enc.encode(*f)]
    dec = registry.create_video_decoder("mpeg4", enc.extradata)
    buffers = [dict(data=p, pts=i * FRAME, duration=FRAME)
               for i, p in enumerate(pkts)]
    fed, tail, _name, _fb = reference(ref_side.decode, "mpeg4",
                                      enc.extradata, buffers)
    for i, (b, want) in enumerate(zip(buffers, fed)):
        a = dec.feed(Buffer(**b))
        assert [(f.pts, f.duration, f.stop) for f in a] == \
            [(pts, d, stop) for pts, d, stop, _p in want] == \
            [(i * FRAME, FRAME, None)]
    assert dec.flush() == tail == []


@needs_libavcodec
def test_reference_child_equals_in_process(reference):
    """The child process that computes the reference's side of these
    comparisons returns the bytes that the same call gives in this
    process: the reference's MPEG-4 encoder on the 8-frame clip (a video
    encoder, which reads no audio frame's layout)."""
    args = ("mpeg4", W, H, frames())
    got = reference(ref_side.video_packets, *args, bit_rate=400000)
    assert len(got) == N
    assert got == ref_side.video_packets(*args, bit_rate=400000)
