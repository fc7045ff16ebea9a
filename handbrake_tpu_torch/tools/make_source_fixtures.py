"""Write the committed source fixtures of the port's disc and stream
tests (``tests/data/torch_sources/``), made by independent encoders.

    python -m handbrake_tpu_torch.tools.make_source_fixtures [--out DIR]

Run it from the repository root on a host with OpenCV (``cv2``) and the
system libavcodec that ``tests/ffvideo.py`` and ``tests/ffdec.py`` load
through ctypes.  The machine with the card has neither, so the files
are made once and committed; the PS/VOB packs, IFOs, TS/m2ts and MPLS
around them are built at run time.  It writes:

- ``mpeg2_720x480.m2v``: 24 frames of a DVD's geometry, MPEG-2 MP@ML
  from libavcodec's ``mpeg2video`` (IBBP, GOP 12, a 6 Mb/s target, 29.97
  fps, progressive);
- ``mpeg2_176x144.m2v``: 12 frames with B-frames, for the CPU tests;
- ``mpeg2_720x576_16x9.m2v``: 25 frames of a 16:9 PAL DVD's picture
  (``pal_dvd_source``): 25 fps (``frame_rate_code`` 3), sample aspect
  64:45, so ``aspect_ratio_information`` 3, IBBP, GOP 12;
- ``mpeg2_ildct_176x160.m2v`` (6 frames) and ``mpeg2_ildct_176x144.m2v``
  (1 frame): ``interlaced_noise``, coded with ``flags=+ildct`` (field
  DCT) and no B-frames, with libavcodec's decode of each in the ``.npz``
  beside it (``y``, ``u``, ``v``: frames x rows x columns, uint8);
- ``mp2_48k_stereo.mp2``: 1.2 s of two tones, MPEG-1 Layer II at 128
  kb/s from libavcodec's ``mp2`` (the port has no MP2 encoder);
- ``mjpeg_640x480.avi``: 6 frames from ``cv2.VideoWriter`` (MJPG);
- the libavcodec catalog's sources (``catalog_sources``), each 176x144,
  12 frames at 30 fps: ``vp9_176x144.webm`` (``libvpx-vp9``),
  ``mpeg4_bframes_176x144.avi`` (``mpeg4`` with 2 B-frames, in decode
  order, FourCC FMP4), ``x265_176x144.mkv`` (``libx265``: CU quadtrees
  and SAO, beyond the port's native HEVC subset) and
  ``eac3_176x144.mkv`` (the port's H.264 encoder on the CPU, with 0.4 s
  of E-AC-3 stereo at 96 kb/s from ``eac3``);
- ``truehd_48k_2.0.thd`` (``truehd_fixture``): 0.5 s of two tones,
  Dolby TrueHD from libavcodec's ``truehd`` encoder (experimental,
  ``strict`` -2; it codes mono and stereo only, so the stream is 2.0),
  its packets, one access unit each, laid end to end; beside it
  ``truehd_48k_2.0.json``, libavcodec's account of it: each unit's
  size, the units its encoder marked as key (those that carry a major
  sync), the samples a unit (the encoder's frame size), and the rate,
  channels and sample count of libavcodec's decode, which equals the
  input's 16-bit samples.

About 1.03 MB in all.  The other frames are ``utils.synth``'s clips,
blurred so the streams stay small.  ``--check`` also codes each
interlaced clip without ``+ildct`` and prints the port decoder's
largest differences from libavcodec on both codings, and rebuilds the
catalog's sources and says whether each equals the committed file.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "tests", "data", "torch_sources")


def _blur(frames, cv2, sigma):
    return [tuple(np.ascontiguousarray(cv2.GaussianBlur(p, (0, 0), sigma))
                  for p in f) for f in frames]


def _mpeg2(ffvideo, frames, w, h, opts, rate=6_000_000):
    enc = ffvideo.FFVideoEncoder("mpeg2video", w, h, 30, bit_rate=rate,
                                 opts=opts)
    return enc.encode(frames)


def pal_dvd_source(ffvideo, cv2) -> bytes:
    """25 frames of a 16:9 PAL DVD (720x576, 25 fps, SAR 64:45, which
    libavcodec codes as aspect_ratio_information 3)."""
    from handbrake_tpu_torch.utils.synth import make_clip
    es = b"".join(_mpeg2(
        ffvideo, _blur(make_clip(720, 576, 25, seed=17), cv2, 3.0),
        720, 576, {"bf": 2, "g": 12, "time_base": "1/25",
                   "aspect": "64/45"}))
    i = es.find(b"\x00\x00\x01\xb3")
    if es[i + 7] != 0x33:
        raise RuntimeError(f"mpeg2video wrote aspect/rate {es[i + 7]:#04x}, "
                           f"not 0x33 (16:9, 25 fps)")
    return es


def interlaced_noise(w, h, n, seed=3):
    """n woven frames: each takes its top field from frame t and its
    bottom field from frame t + 1 of a clip of uniform luma noise that
    pans 3 columns and 1 row a frame, over smooth chroma, so the two
    fields of a frame differ and the encoder picks field DCT."""
    rng = np.random.default_rng(seed)
    luma = rng.integers(20, 230, (h + 64, w + 64)).astype(np.uint8)
    xx = np.arange(w // 2 + 32)[None, :] + np.zeros((h // 2 + 32, 1))
    cb = np.clip(128 + 40 * np.sin(xx / 9.0), 0, 255).astype(np.uint8)
    src = []
    for t in range(n + 1):
        ox, oy = 8 + 3 * t, 8 + t
        src.append((luma[oy:oy + h, ox:ox + w],
                    cb[oy // 2:oy // 2 + h // 2, ox // 2:ox // 2 + w // 2],
                    255 - cb[oy // 2:oy // 2 + h // 2,
                             ox // 2:ox // 2 + w // 2]))
    odd = np.arange(h)[:, None] % 2
    return [tuple(np.ascontiguousarray(np.where(
        odd[:p.shape[0]], q, p)) for p, q in zip(top, bot))
        for top, bot in zip(src[:-1], src[1:])]


def write_avi(path, w, h, fps, chunks, fourcc=b"FMP4"):
    """A one-stream AVI of video chunks in decode order: hdrl (avih,
    strh, BITMAPINFOHEADER), movi ('00dc' chunks) and idx1."""
    import struct

    def chunk(cid, body):
        return cid + struct.pack("<I", len(body)) + body + b"\0" * (
            len(body) & 1)

    def lst(kind, body):
        return chunk(b"LIST", kind + body)
    n = len(chunks)
    avih = struct.pack("<14I", 1_000_000 // fps, 0, 0, 0x10, n, 0, 1,
                       max(map(len, chunks)), w, h, 0, 0, 0, 0)
    strh = struct.pack("<4s4sI2HIIIIIIII4h", b"vids", fourcc, 0, 0, 0, 0,
                       1, fps, 0, n, max(map(len, chunks)), 0xFFFFFFFF, 0,
                       0, 0, w, h)
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, fourcc,
                       w * h * 3, 0, 0, 0, 0)
    hdrl = lst(b"hdrl", chunk(b"avih", avih) + lst(
        b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))
    movi, idx, off = b"", b"", 4
    for data in chunks:
        key = 0x10 if data.find(b"\x00\x00\x01\xb6") >= 0 and \
            data[data.find(b"\x00\x00\x01\xb6") + 4] >> 6 == 0 else 0
        idx += struct.pack("<4sIII", b"00dc", key, off, len(data))
        c = chunk(b"00dc", data)
        movi += c
        off += len(c)
    body = b"AVI " + hdrl + lst(b"movi", movi) + chunk(b"idx1", idx)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


def catalog_sources(out, ffvideo, ffaudio, cv2) -> list:
    """Write the libavcodec catalog's sources into `out`; their names."""
    from handbrake_tpu_torch.codecs.h264.encoder import (EncoderConfig,
                                                         H264Encoder)
    from handbrake_tpu_torch.mux.mkv import MKVWriter
    from handbrake_tpu_torch.utils.synth import make_clip
    w, h, n, fps = 176, 144, 12, 30
    frames = _blur(make_clip(w, h, n, seed=21), cv2, 1.0)
    tick = 90000 // fps

    def mkv(name, codec, pkts, webm=False, audio=None):
        wr = MKVWriter(os.path.join(out, name), webm=webm)
        vi = wr.add_video_track(codec=codec, width=w, height=h,
                                fps=float(fps))
        if audio is not None:
            ai = wr.add_audio_track(codec="eac3", sample_rate=48000,
                                    channels=2)
        for i, p in enumerate(pkts):
            wr.write_sample(vi, p, pts_90k=i * tick, duration_90k=tick,
                            sync=i % 12 == 0,
                            annexb=codec in ("h264", "hevc"))
        for k, p in enumerate(audio or []):
            wr.write_sample(ai, p, pts_90k=k * 2880, duration_90k=2880)
        wr.finalize()

    enc = ffvideo.FFVideoEncoder("libvpx-vp9", w, h, fps, bit_rate=300_000,
                                 opts={"lag-in-frames": 0, "g": 12,
                                       "cpu-used": 4, "threads": 1})
    mkv("vp9_176x144.webm", "vp9", enc.encode(frames), webm=True)
    enc = ffvideo.FFVideoEncoder(
        "libx265", w, h, fps, bit_rate=300_000,
        opts={"x265-params": "bframes=0:keyint=12:pools=none:"
                             "frame-threads=1:log-level=error"})
    mkv("x265_176x144.mkv", "hevc", enc.encode(frames))
    enc = ffvideo.FFVideoEncoder("mpeg4", w, h, fps, bit_rate=300_000,
                                 opts={"bf": 2, "g": 12})
    write_avi(os.path.join(out, "mpeg4_bframes_176x144.avi"), w, h, fps,
              enc.encode(frames))
    h264 = H264Encoder(EncoderConfig(width=w, height=h, qp=30, gop=n),
                       device="cpu")
    t = np.arange(int(48000 * 0.4)) / 48000
    tone = np.stack([0.3 * np.sin(2 * np.pi * f * t) for f in (440, 660)],
                    1).astype(np.float32)
    mkv("eac3_176x144.mkv", "h264",
        [h264.encode_frame(*f) for f in frames],
        audio=ffaudio.FFAudioEncoder("eac3", sample_rate=48000, channels=2,
                                     bit_rate=96000).encode(tone))
    return ["vp9_176x144.webm", "x265_176x144.mkv",
            "mpeg4_bframes_176x144.avi", "eac3_176x144.mkv"]


def truehd_fixture(out) -> list:
    """Write ``truehd_48k_2.0.thd`` and its ``.json`` into `out` with
    the port's libavcodec binding (``codecs/avcodec.py``); their
    names."""
    import ctypes as C
    import json
    from handbrake_tpu_torch.codecs import avcodec as A
    t = np.arange(24000) / 48000
    pcm = np.stack([0.25 * np.sin(2 * np.pi * f * t) for f in (440, 660)],
                   1).astype(np.float32)
    enc = A.AVAudioEncoder("truehd", 48000, 2, 0)
    _u, a = A._libs()
    units, keys = [], []

    def recv(self, packets):
        # each packet with its AV_PKT_FLAG_KEY (AVPacket.flags, byte 40)
        while a.avcodec_receive_packet(C.c_void_p(self.ctx),
                                       C.c_void_p(self.pkt)) >= 0:
            p = C.cast(self.pkt, C.POINTER(C.c_void_p * 6)).contents
            ints = C.cast(self.pkt, C.POINTER(C.c_int * 12)).contents
            units.append(C.string_at(p[3], ints[8]))
            keys.append(bool(ints[10] & 1))
            a.av_packet_unref(C.c_void_p(self.pkt))

    enc._recv = recv.__get__(enc)
    enc.encode(pcm)
    enc.flush()
    dec = A.AVAudioDecoder("truehd", channels=2)
    got = np.concatenate([dec.decode(u) for u in units] + [dec.flush()])
    rate = C.cast(dec.ctx + A._ctx_offsets()["sample_rate"],
                  C.POINTER(C.c_int)).contents.value
    want = np.clip(pcm * 32767.0, -32768, 32767).astype("<i2") / 32768.0
    n = min(len(got), len(want))
    if not np.array_equal(got[:n], want[:n].astype(np.float32)):
        raise RuntimeError("libavcodec's TrueHD decode differs from the "
                           "input")
    with open(os.path.join(out, "truehd_48k_2.0.thd"), "wb") as f:
        f.write(b"".join(units))
    with open(os.path.join(out, "truehd_48k_2.0.json"), "w") as f:
        json.dump({"encoder": "libavcodec truehd, strict -2, s16, 2 "
                              "channels at 48000 Hz",
                   "avcodec_version": a.avcodec_version(),
                   "unit_sizes": [len(u) for u in units],
                   "key_units": [i for i, k in enumerate(keys) if k],
                   "samples_per_unit": enc.frame_size,
                   "decoded_sample_rate": rate,
                   "decoded_channels": dec.channels,
                   "decoded_samples": len(got)}, f, indent=1)
        f.write("\n")
    return ["truehd_48k_2.0.thd", "truehd_48k_2.0.json"]


def report(name, es, ff):
    """--check: the largest |difference| of the port's MPEG-2 decoder
    from libavcodec's decode, frame by frame."""
    from handbrake_tpu_torch.codecs.mpeg2 import Mpeg2Decoder
    try:
        errs = [max(int(np.abs(f[k].astype(int) - g[k]).max())
                    for k in range(3))
                for f, g in zip(Mpeg2Decoder().decode(es), ff)]
    except (ValueError, NotImplementedError) as e:
        errs = repr(e)
    print(f"{name}: {errs}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=OUT)
    p.add_argument("--check", action="store_true",
                   help="print the port's MPEG-2 decoder's largest "
                        "difference from libavcodec on the interlaced "
                        "streams and their frame-DCT twins")
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import cv2
    import ffdec
    import ffvideo
    from handbrake_tpu_torch.utils.synth import make_clip
    if not ffvideo.available():
        raise RuntimeError("libavcodec is not available on this host")
    os.makedirs(args.out, exist_ok=True)

    def write(name, data):
        with open(os.path.join(args.out, name), "wb") as f:
            f.write(data)
        print(f"{name}: {len(data)} bytes")

    ntsc = "1001/30000"
    write("mpeg2_720x480.m2v", b"".join(_mpeg2(
        ffvideo, _blur(make_clip(720, 480, 24, seed=12), cv2, 3.0),
        720, 480, {"bf": 2, "g": 12, "time_base": ntsc})))
    write("mpeg2_176x144.m2v", b"".join(_mpeg2(
        ffvideo, _blur(make_clip(176, 144, 12, seed=13), cv2, 0.8),
        176, 144, {"bf": 2, "g": 12, "time_base": ntsc}, rate=800_000)))
    write("mpeg2_720x576_16x9.m2v", pal_dvd_source(ffvideo, cv2))
    for (w, h), n in (((176, 160), 6), ((176, 144), 1)):
        frames = interlaced_noise(w, h, n)
        for name, flags in (("ildct", "+ildct"), ("frame_dct", None)):
            opts = {"bf": 0, "time_base": ntsc}
            if flags:
                opts["flags"] = flags
            pkts = _mpeg2(ffvideo, frames, w, h, opts, rate=1_500_000)
            ff = ffdec.decode_yuv_packets(pkts, "mpeg2video")
            if args.check:
                report(f"mpeg2_{name}_{w}x{h}", b"".join(pkts), ff)
            if not flags:
                continue      # the frame-DCT twin is only measured
            write(f"mpeg2_ildct_{w}x{h}.m2v", b"".join(pkts))
            path = os.path.join(args.out, f"mpeg2_ildct_{w}x{h}.npz")
            np.savez_compressed(path, **{
                k: np.stack([f[i] for f in ff]) for i, k in enumerate("yuv")})
            print(f"{os.path.basename(path)}: {os.path.getsize(path)} bytes")
    import ffaudio
    from handbrake_tpu_torch.audio.aac import AACEncoder
    t = np.arange(int(48000 * 1.2)) / 48000
    tone = np.stack([0.3 * np.sin(2 * np.pi * f * t) for f in (440, 660)],
                    1).astype(np.float32)
    # ffaudio finds its frame layout's offsets on a first decode
    probe = AACEncoder(48000, 2, quality=120)
    ffaudio.FFAudioDecoder("aac").decode_packets(
        [ffaudio.adts_wrap([pk], sample_rate=48000, channels=2)
         for pk in probe.encode(tone[:2048]) + probe.flush()])
    write("mp2_48k_stereo.mp2", b"".join(ffaudio.FFAudioEncoder(
        "mp2", sample_rate=48000, channels=2, bit_rate=128000,
        sample_fmt="s16").encode(tone)))
    avi = os.path.join(args.out, "mjpeg_640x480.avi")
    vw = cv2.VideoWriter(avi, cv2.VideoWriter_fourcc(*"MJPG"), 25,
                         (640, 480))
    for y, u, v in _blur(make_clip(640, 480, 6, seed=15), cv2, 3.0):
        yuv = cv2.merge([y, cv2.resize(v, (640, 480)),
                         cv2.resize(u, (640, 480))])
        vw.write(cv2.cvtColor(yuv, cv2.COLOR_YCrCb2BGR))
    vw.release()
    print(f"mjpeg_640x480.avi: {os.path.getsize(avi)} bytes")
    for name in catalog_sources(args.out, ffvideo, ffaudio, cv2) \
            + truehd_fixture(args.out):
        print(f"{name}: {os.path.getsize(os.path.join(args.out, name))} "
              f"bytes")
    if args.check:
        import filecmp
        import tempfile
        with tempfile.TemporaryDirectory() as again:
            for name in catalog_sources(again, ffvideo, ffaudio, cv2):
                same = filecmp.cmp(os.path.join(again, name),
                                   os.path.join(args.out, name),
                                   shallow=False)
                print(f"{name}: rebuilt {'equal' if same else 'DIFFERS'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
