"""Work orchestrator — job → finished file (reference: libhb/work.c
work_func/do_job, SURVEY.md §3.2); the counterpart of
``handbrake_tpu/work.py``.

Pipeline assembly per pass:
  source demux → video decode → sync → filter chain → video encode ┐
               → audio decode → sync → audio encode ──────────────┼→ mux
The stages run one thread each with bounded FIFOs between them
(core/pipeline.py, the work.c:2242 assembly).  The filter chain and the
encoder share the ``filter+encode`` thread, so one CUDA stream carries
the crop/scale products and the encoder's analysis; the audio chains run
on the same thread, on the host, as in the reference.

The port runs H.264, HEVC (Main and Main 10) and AV1 jobs from y4m,
H.264 (annex-B, mp4, mkv, TS, PS), HEVC (annex-B, mp4, mkv, TS), AV1 (mp4,
mkv), MPEG-2 (PS/VOB, TS, DVD and Blu-ray folders) and MJPEG (AVI)
sources into mp4, mkv or webm, with audio tracks decoded from PCM, DVD LPCM, AAC,
AC-3, MP2 and FLAC and encoded to AAC, AC-3, FLAC or PCM, or passed through, and with
subtitles: SRT/SSA/VTT files imported, PGS, VobSub and text tracks of the
source and CEA-608 captions of an H.264 stream decoded, each kept as a
tx3g (mp4) or S_TEXT/UTF8 (mkv) track or burned in by the render_sub
filter on the job's device.  A DVD's VobSub tracks take the IFO's
palette, and CEA-608 captions also come from MPEG-2 user data.  The device comes only from the caller
(``device=None`` is the CUDA card, which raises where there is none).
The libavcodec audio codecs raise NotImplementedError: they are a later
slice.  An audio track that cannot be decoded raises, and so does a
subtitle track; none is passed through or dropped in its place.

``checkpoint`` journals every muxed sample to ``<dest>.ckpt``
(``checkpoint.py``) with a marker at each GOP boundary; ``resume``
replays the complete GOPs, cuts the journal there and restarts the
pipeline at the boundary, with the rate controller's state and the
encoder's ``idr_pic_id`` restored, so the resumed file equals the
uninterrupted one.  A resume without a journal, or from a file that is
not one, raises.

``gop_parallel`` N codes each window of frames as G = min(N, frames)
keyframe-aligned GOPs (``parallel/gop.py``), dealt out over the ranks of
the process group when ``torchrun`` started one (``parallel/mesh.py``:
rank 0 runs the job, the other ranks serve its work items; on a rank
other than 0 ``do_job`` serves until rank 0 closes the world, and
returns).  The reference shards the GOPs over its devices and takes G =
min(N, devices, frames); the port's G does not depend on the rank count,
and one rank runs the GOPs as a loop.  With a multipass bitrate each
window runs the two-pass GOP allocator.  ``tile_parallel`` N is handed to
nlmeans, which cuts each plane into min(N, ranks) row tiles over the
ranks, or runs untiled on one rank.

With ``bframes`` the video goes through the host B-frame walker
(``codecs/h264/encoder_b.py``, CAVLC, constant qp) while the filter graph
stays on the job's device; its access units come out in decode order,
each stamped with its display frame's timestamps.  Such a job with a
bitrate or multipass target raises WorkError: the walker has no rate
control, and the reference ignores the target.

HEVC and AV1 jobs code each frame on the host walker
(``codecs/hevc/encoder.py``, ``codecs/av1/encoder.py``), whose P frames'
motion search runs on the job's device (``analyzer.py`` of each codec).
They take no B-frames and no GOP-parallel encoding: each raises
WorkError, where the reference codes I and P frames without a word, and
logs that it ignores ``gop_parallel`` and codes the job serially.

A burned text cue is rasterized into the part of the source frame that
the job's crop keeps, and placed there, so it lands bottom-centred in the
output picture.  The reference lays it out for the output size but blends
it onto the uncropped source frame (render_sub runs before crop_scale),
which puts it elsewhere on a cropped or scaled job; on an uncropped,
unscaled job the two agree.
"""
from __future__ import annotations

import os
from fractions import Fraction

import numpy as np
import torch

from . import checkpoint
from .audio.aacdec import DECODABLE_AOTS, AACDecoder, AACUnsupported
from .codecs.registry import create_video_decoder
from .core.buffer import Buffer, CLOCK, Geometry, PIX_FMTS
from .core.pipeline import WorkObject
from .core.state import Progress
from .filters.base import FilterInit
from .filters.graph import FilterGraph
from .job.schema import Job
from .sources.probe import open_source
from .sync.sync import SyncCore
from .utils.device import resolve_device
from .utils.logging import log

H264_NAMES = ("h264_tpu", "x264", "h264")
HEVC_NAMES = ("hevc_tpu", "x265", "hevc", "h265")
AV1_NAMES = ("av1_tpu", "svt_av1", "av1")


class WorkError(Exception):
    pass


def _unported(what: str):
    raise NotImplementedError(f"{what} is not ported yet")


# ---------------------------------------------------------------------------
# encoders
# ---------------------------------------------------------------------------
def quality_to_qp(quality: float) -> int:
    """CRF-style quality → QP for our encoder (x264 RF≈QP at crf zone)."""
    return int(round(max(0, min(51, quality))))


def create_video_encoder(job: Job, width: int, height: int,
                         vrate: Fraction, device=None):
    """The H.264, HEVC or AV1 encoder of the job's settings, on `device`
    (None: the CUDA card).  The H.264 encoder's dispatch_batch stays 1,
    as on the reference's job path."""
    qp = quality_to_qp(job.quality if job.quality is not None else 26)
    gop = max(1, int(round(float(vrate) * 10)))  # 10 s keyint, x264 dflt
    opts = dict(kv.split("=", 1) for kv in
                (job.encoder_options or "").split(":") if "=" in kv)
    if "keyint" in opts:
        gop = max(1, int(opts["keyint"]))
    bframes = int(getattr(job, "bframes", 0) or 0)
    if bframes > 0 and job.vcodec in HEVC_NAMES + AV1_NAMES:
        # the reference codes such a job P-only without a word
        raise WorkError(f"the {job.vcodec} encoder codes I and P frames "
                        f"only: it takes no B-frames")
    if job.vcodec in H264_NAMES and bframes > 0:
        if job.vbitrate or job.multipass:
            # the reference encodes such a job at cfg.qp and ignores
            # the target
            raise WorkError("a B-frame job encodes at a constant qp: it "
                            "takes a quality, not a bitrate or multipass "
                            "target")
        # IB..BP GOP structure via the host B walker (encoder_b.py —
        # x264-medium's bframes=3/ref=3 shape; CAVLC)
        from .codecs.h264.encoder import EncoderConfig
        from .codecs.h264.encoder_b import H264BEncoder
        cfg = EncoderConfig(
            width=width, height=height, qp=qp, gop=gop,
            fps=(vrate.numerator, vrate.denominator), backend="host")
        return _BFrameEncoderAdapter(
            H264BEncoder(cfg, bframes=bframes, refs=min(3, bframes + 1)))
    if job.vcodec in H264_NAMES:
        from .codecs.h264.encoder import EncoderConfig, H264Encoder
        # Entropy coder selection (encx264.c profile plumbing): main/high
        # profile or a cabac=1 option turns on CABAC
        cabac = (job.encoder_profile in ("main", "high")
                 or opts.get("cabac", "0") == "1")
        # x264 defaults: in-loop deblocking on (no-deblock opts out);
        # High profile adds the 8x8 transform — all run in the device path
        deblock = opts.get("deblock", "1") != "0"
        t8 = (job.encoder_profile == "high"
              or opts.get("8x8dct", "0") == "1")
        cfg = EncoderConfig(
            width=width, height=height, qp=qp, gop=gop, cabac=cabac,
            deblock=deblock, transform8x8=t8,
            fps=(vrate.numerator, vrate.denominator))
        return H264Encoder(cfg, device=device)
    if job.vcodec in HEVC_NAMES:
        from .codecs.hevc.encoder import EncoderConfig, HEVCEncoder
        bd = 10 if "10" in (job.encoder_profile or "") else 8
        cfg = EncoderConfig(
            width=width, height=height, qp=qp, gop=gop, bit_depth=bd,
            fps=(vrate.numerator, vrate.denominator))
        return HEVCEncoder(cfg, device=device)
    if job.vcodec in AV1_NAMES:
        from .codecs.av1.encoder import AV1Encoder, EncoderConfig
        cfg = EncoderConfig(
            width=width, height=height, qp=qp, gop=gop,
            fps=(vrate.numerator, vrate.denominator))
        return AV1Encoder(cfg, device=device)
    if job.vcodec in ("mpeg2", "mpeg4", "vp9", "vp8", "ffv1", "prores",
                      "theora"):
        _unported(f"the {job.vcodec} video encoder (the libavcodec "
                  f"catalog, ROADMAP item 1.10)")
    raise WorkError(f"unknown video encoder {job.vcodec!r}")


class _BFrameEncoderAdapter:
    """Wraps H264BEncoder for the encode stage: display frames in,
    (display_idx, access_unit) pairs out in DECODE order — the caller
    owns the DTS delay queue (encx264.c:30 role).  A frame's
    reconstruction leaves the walker's ``recons`` once its access unit
    is out, so a job holds no more than one group's besides the
    walker's reference pictures (the reference keeps every one of them
    for the whole job)."""

    def __init__(self, benc):
        self.benc = benc
        self.cfg = benc.cfg

    @property
    def idr_pic_id(self) -> int:
        """The walker's next IDR id, which a resume restores (the
        reference's adapter has none, so its resumed B-frame job restarts
        the count and differs from its uninterrupted run)."""
        return self.benc.idr_pic_id

    @idr_pic_id.setter
    def idr_pic_id(self, v: int):
        self.benc.idr_pic_id = int(v)

    def _release(self, aus: list) -> list:
        for d, _au in aus:
            self.benc.recons.pop(d, None)
        return aus

    def push_display_frame(self, y, u, v):
        return self._release(self.benc.push_frame(y, u, v))

    def flush(self):
        return self._release(self.benc.flush())


# ---------------------------------------------------------------------------
# range selection (Source.Range — hb_json.c job schema)
# ---------------------------------------------------------------------------
def resolve_range(job: Job, src, vrate: Fraction) -> tuple:
    """(pts_start, pts_stop) in 90 kHz ticks, either may be None."""
    r = job.range
    if r.type == "time":          # seconds
        start = r.start * CLOCK
        stop = r.end * CLOCK if r.end else None
        return (start or None), stop
    if r.type == "frame":
        tick = CLOCK * vrate.denominator / vrate.numerator
        start = int((r.start - 1) * tick) if r.start > 1 else None
        # half-frame tolerance: containers with ms timestamp precision
        # (mkv) place frame pts slightly under the exact boundary
        stop = int(r.end * tick - tick / 2) if r.end else None
        return start, stop
    if r.type == "chapter":
        chapters = getattr(src, "chapters", [])
        if not chapters or (r.start <= 1 and not r.end):
            return None, None
        starts = [c[0] for c in chapters]
        dur = getattr(src, "duration", 0)
        start = starts[r.start - 1] if 0 < r.start <= len(starts) else None
        stop = starts[r.end] if 0 < r.end < len(starts) else \
            (dur or None) if r.end else None
        return (start or None), stop
    return None, None


# ---------------------------------------------------------------------------
# do_job
# ---------------------------------------------------------------------------
def do_job(job: Job, state=None, die=None, pause=None, device=None) -> dict:
    """Run one pass of a job on `device` (None: the CUDA card; "cpu"
    runs on the CPU).  Returns stats dict (frames, bytes, ...)."""
    dev = resolve_device(device)
    from .parallel.mesh import init_world
    world = init_world(device)
    if world is not None and world.rank != 0:
        world.serve()
        return {"frames_in": 0, "frames_out": 0, "bytes_out": 0,
                "served": dict(world.stats)}
    if int(job.gop_parallel or 0) > 1 and int(job.bframes or 0) > 0:
        # the reference's GOP-parallel path codes IDR + P GOPs and drops
        # the B-frames it was asked for
        raise WorkError("GOP-parallel encoding codes I and P frames only: "
                        "it takes no B-frames")
    if int(job.gop_parallel or 0) > 1 \
            and job.vcodec in HEVC_NAMES + AV1_NAMES:
        # the reference logs that it ignores the request and codes the
        # job serially
        raise WorkError(f"GOP-parallel encoding codes H.264 only, not "
                        f"{job.vcodec}")
    src = open_source(job.path)
    try:
        return _run(job, src, state, die, pause, dev)
    finally:
        src.close()


def _run(job: Job, src, state, die, pause, dev: torch.device) -> dict:
    # ---- identify tracks ----
    video_track = next((i for i, t in enumerate(src.tracks)
                        if t.kind == "video"), None)
    if video_track is None:
        raise WorkError("no video track")
    vti = src.tracks[video_track]
    vrate = Fraction(*vti.frame_rate) if vti.frame_rate \
        else Fraction(30000, 1001)
    audio_sel = []            # (src_track_index, AudioJobTrack)
    audio_srcs = [i for i, t in enumerate(src.tracks) if t.kind == "audio"]
    for a in job.audio:
        if 0 <= a.track < len(audio_srcs):
            audio_sel.append((audio_srcs[a.track], a))

    # ---- decoders ----
    vdec = create_video_decoder(vti.codec, vti.extradata,
                                width=vti.width, height=vti.height)
    adecs = {}
    for si, spec in audio_sel:
        adecs[si] = _make_audio_decoder(src.tracks[si], spec)

    # ---- sync ----
    pts_start, pts_stop = resolve_range(job, src, vrate)
    sync = SyncCore(pts_start=pts_start, pts_stop=pts_stop)
    # video geometry lets sync synthesize black frames for gaps
    # (CreateBlackBuf sync.c:349); frame cadence is tracked per buffer
    v_sync = sync.add_stream(
        "video", width=vti.width, height=vti.height,
        frame_duration=int(90000 / float(vrate)) if vrate else None)
    # PCM geometry lets sync synthesize silence for gaps (CreateSilenceBuf
    # analog); passthrough tracks get no fill (compressed domain)
    a_sync = {}
    for si, _spec in audio_sel:
        ti = src.tracks[si]
        pcm = ti.codec in ("pcm_s16le", "lpcm", "flac", "aac", "ac3",
                           "mp2")
        a_sync[si] = sync.add_stream(
            "audio", sid=si,
            sample_rate=ti.sample_rate if pcm else None,
            channels=max(1, ti.channels))

    # ---- subtitles (SRT import + in-stream bitmap and text tracks) ----
    sub_sel = []              # (key, SubtitleJobTrack, [SubEvent])
    sdecs = {}                # source track idx -> (key, decoder)
    sub_srcs = [i for i, t in enumerate(src.tracks)
                if t.kind == "subtitle"]
    cc_sel = None             # (key, Cea608Decoder) — captions ride
                              # the VIDEO stream (deccc608sub.c role)
    for k, sspec in enumerate(job.subtitles):
        if getattr(sspec, "cc", False):
            from .subtitles.cea608 import Cea608Decoder
            cc_sel = (k, Cea608Decoder())
        elif sspec.import_file:
            from .subtitles import parse_textsub
            with open(sspec.import_file, "rb") as f:
                events = parse_textsub(f.read(),
                                       fmt=sspec.import_format,
                                       offset_ms=sspec.offset)
            sub_sel.append((k, sspec, events))
        elif 0 <= sspec.track < len(sub_srcs):
            sti = src.tracks[sub_srcs[sspec.track]]
            if sti.codec == "pgs":
                # PGS bitmap decode (decavsub.c:739 personality)
                from .subtitles.pgs import PgsDecoder
                sdecs[sub_srcs[sspec.track]] = (k, PgsDecoder())
            elif sti.codec == "vobsub":
                # DVD subpicture decode (decavsub VOBSUB personality)
                from .subtitles.vobsub import (VobSubDecoder,
                                               parse_idx_palette)
                pal = parse_idx_palette(sti.extradata or b"")
                sdecs[sub_srcs[sspec.track]] = (k, VobSubDecoder(pal))
            elif sti.codec in ("tx3g", "text", "srt", "subrip", "ass",
                               "ssa"):
                # in-stream text cues (dectx3gsub.c / decssasub.c roles)
                sdecs[sub_srcs[sspec.track]] = (
                    k, _TextCueDecoder(sti.codec))
            else:
                # the reference logs and drops such a track
                raise WorkError(f"subtitle codec {sti.codec!r}: no decoder")
    s_sync = {}
    for k, sspec, events in sub_sel:
        s_sync[k] = sync.add_stream("subtitle", sid=_SUB_SID0 + k)
        for e in events:
            b = Buffer(track_kind="subtitle", pts=e.pts, stop=e.stop,
                       duration=e.duration)
            b.data = e.text.encode("utf-8")
            b.stream_id = _SUB_SID0 + k
            sync.queue(s_sync[k], b)
        sync.set_eof(s_sync[k])
    for trk, (k, _dec) in sdecs.items():
        s_sync[k] = sync.add_stream("subtitle", sid=_SUB_SID0 + k)
    if cc_sel is not None:
        s_sync[cc_sel[0]] = sync.add_stream(
            "subtitle", sid=_SUB_SID0 + cc_sel[0])
    sub_specs = {k: sspec for k, sspec, _ in sub_sel}
    sub_specs.update({k: job.subtitles[k] for _t, (k, _d) in
                      sdecs.items()})
    if cc_sel is not None:
        sub_specs[cc_sel[0]] = job.subtitles[cc_sel[0]]

    # ---- filters ----
    fi = FilterInit(geometry=Geometry(
        vti.width, vti.height, vti.par_num, vti.par_den),
        pix_fmt=PIX_FMTS.get("yuv420p"), vrate=vrate, device=dev)
    filter_list = [{"ID": f.id, "Settings": f.settings}
                   for f in job.filters]
    if job.anamorphic_mode is not None:
        # resolve the geometry request (hb_set_anamorphic_size2) against
        # the source + requested crop, overriding the crop/scale target
        from .job import schema as S
        from .job.geometry import GeometrySettings, set_anamorphic_size2
        cs = next((f for f in filter_list
                   if f["ID"] == S.FILTER_CROP_SCALE), None)
        st = dict(cs["Settings"]) if cs else {}
        crop = (st.get("crop-top", 0), st.get("crop-bottom", 0),
                st.get("crop-left", 0), st.get("crop-right", 0))
        gw, gh, gpar, _dw = set_anamorphic_size2(
            vti.width, vti.height,
            Fraction(vti.par_num or 1, vti.par_den or 1),
            GeometrySettings(mode=job.anamorphic_mode,
                             width=st.get("width", 0),
                             height=st.get("height", 0),
                             max_width=job.max_width,
                             max_height=job.max_height,
                             modulus=job.modulus,
                             keep_display_aspect=job.keep_display_aspect,
                             par_num=job.par_num, par_den=job.par_den,
                             crop=crop))
        st.update({"width": gw, "height": gh})
        if cs is None:
            filter_list.append({"ID": S.FILTER_CROP_SCALE,
                                "Settings": st})
        else:
            cs["Settings"] = st
        job.par_num, job.par_den = gpar.numerator, gpar.denominator
        fi.geometry = Geometry(vti.width, vti.height,
                               gpar.numerator, gpar.denominator)
    if any(s.burn for s in sub_specs.values()):
        # auto-insert the burn-in filter (work.c subtitle sanitize analog)
        from .job import schema as S
        if not any(f["ID"] == S.FILTER_RENDER_SUB for f in filter_list):
            filter_list.append({"ID": S.FILTER_RENDER_SUB, "Settings": {}})
    tp = int(job.tile_parallel or 0)
    if tp > 1:
        # nlmeans takes the tile count (on one rank it runs untiled)
        from .job import schema as S
        for f in filter_list:
            if f["ID"] == S.FILTER_NLMEANS:
                f["Settings"] = dict(f.get("Settings") or {},
                                     tile_parallel=tp)
    graph = FilterGraph(filter_list, fi)
    out_fi = graph.fi_out
    out_w, out_h = out_fi.geometry.width, out_fi.geometry.height
    out_vrate = out_fi.vrate

    # ---- encoders ----
    venc = create_video_encoder(job, out_w, out_h, out_vrate, device=dev)
    from .codecs.ratecontrol import make_rate_controller
    rc = make_rate_controller(job, out_w, out_h, float(out_vrate))
    aencs = {}
    for si, spec in audio_sel:
        aencs[si] = _make_audio_encoder(spec, src.tracks[si])

    # ---- checkpoint/resume: resume replays the journal's complete GOPs,
    # restores the rate controller and restarts at the boundary ----
    ckpt = None
    replay = []
    if (job.checkpoint or job.resume) and job.pass_id != 1:
        ckpt_path = (job.file or "out") + ".ckpt"
        n_done = 0
        if job.resume:
            if not os.path.exists(ckpt_path):
                raise WorkError(f"resume: no checkpoint journal at "
                                f"{ckpt_path}")
            replay, n_done, rc_state, cut = checkpoint.load(ckpt_path)
            # drop the torn tail before appending (the reference appends
            # after it, and a second crash replays it)
            checkpoint.cut_to(ckpt_path, cut)
            if n_done > 0:
                gops_done = rc_state.pop("_gops_done")
                rc.__dict__.update(rc_state)
                # the resumed encoder's idr_pic_id keeps counting
                if hasattr(venc, "idr_pic_id"):
                    venc.idr_pic_id = gops_done % 16
                # continue n_done frames after the job's own start and
                # keep its end (the reference restarts at source frame
                # n_done + 1 and drops the end)
                tick = CLOCK * vrate.denominator / vrate.numerator
                if job.range.type == "frame":
                    # on the frame grid, as resolve_range places it
                    pts_start = int((max(1, job.range.start) - 1 + n_done)
                                    * tick)
                else:
                    pts_start = int((pts_start or 0) + n_done * tick)
                sync.pts_start = pts_start
                sync.common_start = None
                log(f"resume: {n_done} frames from checkpoint, "
                    f"continuing {n_done} frames after the job's start")
            else:
                log("resume: the journal holds no complete GOP, "
                    "starting at frame 1")
        ckpt = checkpoint.CkptJournal(ckpt_path, rc, append=n_done > 0,
                                      frames0=n_done)

    # ---- muxer (analysis pass writes nowhere — x264 pass-1 analog) ----
    if job.pass_id == 1:
        mux = _NullMux()
    else:
        mux = _MuxAdapter(job, out_fi, audio_sel, src, aencs,
                          sub_specs=sub_specs)
        if ckpt is not None:
            mux.journal = ckpt
            for rec in replay:
                mux.replay(rec)

    # ---- threaded stage graph (work.c:2242-2280: one thread per work
    # object, bounded FIFOs between; reader → decode+sync → filters+encode
    # → mux). IO, device analysis, host entropy coding and mux overlap
    # across the four threads; fifo capacity is the backpressure.
    stats = {"frames_in": 0, "frames_out": 0, "bytes_out": 0}
    nframes = getattr(src, "n_frames", 0) or (
        getattr(src, "duration", 0) * out_vrate.numerator
        // max(1, out_vrate.denominator * CLOCK))
    progress = Progress(int(nframes) or 1, state.update if state else
                        (lambda **kw: None))
    start_state = None
    if pts_start:
        start_state = src.seek(pts_start)
    it = src.packets(start_state) if start_state is not None \
        else src.packets()

    from .core.pipeline import Pipeline
    pl = Pipeline()
    fifo_raw = pl.make_fifo(32, "raw")       # FIFO_LARGE (work.c:40-47)
    fifo_sync = pl.make_fifo(32, "sync")
    fifo_enc = pl.make_fifo(32, "enc")

    reader = _ReaderStage(it, die, pause)
    reader.fifo_out = fifo_raw
    decsync = _DecodeSyncStage(video_track, vdec, adecs, sync, v_sync,
                               a_sync, stats, vcodec=vti.codec,
                               sdecs=sdecs, s_sync=s_sync, cc_sel=cc_sel)
    decsync.fifo_in, decsync.fifo_out = fifo_raw, fifo_sync
    encst = _EncodeStage(graph, venc, aencs, rc, stats, progress,
                         sub_specs, text_area(filter_list, vti.width,
                                              vti.height),
                         gop_parallel=int(job.gop_parallel or 0),
                         multipass=bool(job.multipass),
                         target_kbps=float(job.vbitrate or 0),
                         out_wh=(out_w, out_h), device=dev)
    encst.fifo_in, encst.fifo_out = fifo_sync, fifo_enc
    muxst = _MuxStage(mux, aencs)
    muxst.fifo_in = fifo_enc

    for w in (reader, decsync, encst, muxst):
        pl.add_work(w)
    pl.run()          # joins on the mux thread (work.c:2287)
    if pl.error is not None:
        raise pl.error

    if job.pass_id == 1:
        # hand measured complexity to the final pass (hb_interjob_t role)
        job.interjob["rc_stats"] = rc.stats
        job.interjob["vrate_measured"] = float(out_vrate)
    if state is not None:
        state.update(progress=1.0)
    stats["width"], stats["height"] = out_w, out_h
    return stats


_SUB_SID0 = 1000   # subtitle stream ids live above source track indexes


def text_area(filter_list: list, width: int, height: int) -> tuple:
    """(w, h, left, top): the part of a width x height source frame that
    the job's crop keeps, where a burned text cue is rasterized and
    placed.  render_sub runs before crop_scale on the source frame; only
    rotate can come between them, and with it the whole frame is used."""
    from .job import schema as S
    ids = [f["ID"] for f in filter_list]
    cs = next((f for f in filter_list
               if f["ID"] == S.FILTER_CROP_SCALE), None)
    if cs is None or S.FILTER_ROTATE in ids:
        return width, height, 0, 0
    st = cs.get("Settings") or {}
    t, b, left, r = (int(st.get(k, 0)) for k in (
        "crop-top", "crop-bottom", "crop-left", "crop-right"))
    return width - left - r, height - t - b, left, t


# ---------------------------------------------------------------------------
# pipeline stages (hb_work_object_t analogs; core/pipeline.py runs one
# thread per stage with bounded FIFOs — the work.c:2242 assembly)
# ---------------------------------------------------------------------------
class _ReaderStage(WorkObject):
    """Generator stage: source packets → fifo (reader.c role)."""
    name = "reader"

    def __init__(self, it, die, pause):
        super().__init__()
        self.it = it
        self.die = die
        self.pause = pause

    def generate(self):
        for trk, pkt in self.it:
            if self.pause is not None:
                self.pause.wait()
            if self.die is not None and self.die.is_set():
                break
            pkt.stream_id = trk
            yield pkt
        yield Buffer.eof()


class _DecodeSyncStage(WorkObject):
    """Decode per track and run the synchronizer (decavcodec + sync.c)."""
    name = "decode+sync"

    def __init__(self, video_track, vdec, adecs, sync, v_sync, a_sync,
                 stats, vcodec="", sdecs=None, s_sync=None, cc_sel=None):
        super().__init__()
        self.cc_sel = cc_sel       # (key, Cea608Decoder) or None
        self.video_track = video_track
        self.vdec = vdec
        self.adecs = adecs
        self.sync = sync
        self.v_sync = v_sync
        self.a_sync = a_sync
        self.stats = stats
        self.vcodec = vcodec
        self.sdecs = sdecs or {}
        self.s_sync = s_sync or {}
        self._hdr: dict = {}       # static + pending per-frame metadata

    def _queue_video(self, f, flush=False):
        """Queue a decoded frame with the source's HDR metadata: the
        static SEIs on every frame, a T.35 payload and a Dolby Vision
        RPU on the next one only, except at the EOF flush, which
        attaches all it holds to every frame it drains."""
        if self._hdr:
            f.side_data.update(self._hdr)
            if not flush:
                self._hdr.pop("hdr10plus_t35", None)
                self._hdr.pop("dovi_rpu", None)
        self.sync.queue(self.v_sync, f)
        self.stats["frames_in"] += 1

    def _feed_cc(self, es: bytes, pts):
        """CEA-608 captions ride the video ES (deccc608sub.c role):
        extract GA94 cc_data from MPEG-2 user_data or H.264 SEI and
        decode to text cues on the caption subtitle stream."""
        from .subtitles.cea608 import extract_cc_h264, extract_cc_mpeg2
        key, dec = self.cc_sel
        if self.vcodec in ("mpeg2", "mpeg2video"):
            pairs = extract_cc_mpeg2(es)
        elif self.vcodec == "h264":
            pairs = extract_cc_h264(es)
        else:
            return
        for ev in dec.feed(pairs, pts or 0):
            b = Buffer(track_kind="subtitle", pts=ev.pts, stop=ev.stop,
                       duration=ev.duration)
            b.data = ev.text.encode("utf-8")
            b.stream_id = _SUB_SID0 + key
            self.sync.queue(self.s_sync[key], b)

    def _emit_sub(self, key, ev):
        """Queue one bitmap event (or clear marker) immediately: a PGS
        display set replaces the screen, events persist until the next
        set (render_sub's clear semantics)."""
        b = Buffer(track_kind="subtitle", pts=ev.pts, stop=None)
        if ev.rgba is None:
            b.sub_clear = True
        else:
            b.planes = [ev.rgba]
            b.rect = (ev.x, ev.y)
        b.stream_id = _SUB_SID0 + key
        self.sync.queue(self.s_sync[key], b)

    def work(self, buf):
        if buf.is_eof():
            for f in self.vdec.flush():
                self._queue_video(f, flush=True)
            for idx in range(len(self.sync.streams)):
                self.sync.set_eof(idx)
            out = self.sync.poll()
            out += self.sync.poll()      # tail after EOF
            # cadence classifier consumer (checkCadence sync.c:1305)
            cad = self.sync.cadence.info()
            self.stats["cadence"] = cad["cadence"]
            self.stats["cadence_breaks"] = cad["breaks"]
            return out + [buf]
        trk = buf.stream_id
        if trk == self.video_track:
            if buf.planes is None and buf.data \
                    and self.vcodec in ("h264", "hevc"):
                # HDR metadata rides SEI/RPU NALs in the source ES
                # (hdr10plus.c:133, rpu.c:245 roles)
                from .codecs.hdr import extract_hdr_side_data
                self._hdr.update(extract_hdr_side_data(buf.data,
                                                       self.vcodec))
            if self.cc_sel is not None and buf.data:
                self._feed_cc(bytes(buf.data), buf.pts)
            frames = [buf] if buf.planes is not None else self.vdec.feed(buf)
            for f in frames:
                self._queue_video(f)
        elif trk in self.adecs:
            for ab in self.adecs[trk].feed(buf):
                self.sync.queue(self.a_sync[trk], ab)
        elif trk in self.sdecs and buf.data is not None:
            key, dec = self.sdecs[trk]
            if isinstance(dec, _TextCueDecoder):
                txt = dec.parse(bytes(buf.data))
                if txt:
                    b = Buffer(track_kind="subtitle", pts=buf.pts,
                               duration=buf.duration)
                    b.stop = (buf.pts + buf.duration) \
                        if buf.pts is not None and buf.duration else None
                    b.data = txt.encode("utf-8")
                    b.stream_id = _SUB_SID0 + key
                    self.sync.queue(self.s_sync[key], b)
            else:
                for ev in dec.feed(bytes(buf.data), buf.pts or 0):
                    self._emit_sub(key, ev)
        return self.sync.poll()


def to_host(p) -> np.ndarray:
    """A plane on the host: tensors (the resampled planes, on the job's
    device) are copied back explicitly, numpy passes through."""
    return p.cpu().numpy() if isinstance(p, torch.Tensor) else np.asarray(p)


class _EncodeStage(WorkObject):
    """Filter graph + encoders. Video uses the encoder's begin/finish
    pipelining so the device analyses frame N+1 while this thread
    entropy-codes frame N (encx264 lookahead role); a B-frame job's
    walker takes display frames and returns decode-order access units.
    Each audio track's chain encodes its PCM on the host between video
    frames.  A burned subtitle event goes to the graph's render_sub (a
    text cue rasterized first, into `text_area`), a kept one on to the
    mux.  With gop_parallel > 1 the video is buffered a window at a time
    and coded as independent GOPs (``parallel/gop.py``).  Each IDR's
    buffer carries the rate controller's state from just before that
    frame's qp was chosen, which the checkpoint journal keeps as a resume
    point; in gop-parallel mode only a window's first frame does, since a
    resume must find the windows the uninterrupted run cut."""
    name = "filter+encode"

    def __init__(self, graph, venc, aencs, rc, stats, progress,
                 sub_specs=None, text_area=(0, 0, 0, 0), gop_parallel=0,
                 multipass=False, target_kbps=0.0, out_wh=(0, 0),
                 device=None):
        super().__init__()
        self.gop_parallel = int(gop_parallel or 0)
        self._gp_frames = []   # buffered (planes, fb) in gop-parallel mode
        self.multipass = bool(multipass)
        self.target_kbps = float(target_kbps or 0.0)
        self.out_wh = out_wh
        self.device = device
        self.sub_specs = sub_specs or {}
        self.text_area = text_area
        self.graph = graph
        self.venc = venc
        self.aencs = aencs
        self.rc = rc
        self.stats = stats
        self.progress = progress
        self._pend = []   # (pending, fb, qp, is_idr, rc state at an IDR)
        self._b_fbs = {}  # display idx -> frame, B-frame job
        self._b_disp = 0
        from .codecs.h264.encoder import H264Encoder
        from .codecs.hevc.encoder import HEVCEncoder
        # the reference matches the class name, so its B-frame adapter
        # writes no SEI either
        self._sei = {H264Encoder: "h264", HEVCEncoder: "hevc"}.get(
            type(venc))

    def _planes(self, fb):
        # the encoder takes host planes and pads and uploads them itself
        y, u, v = (to_host(p) for p in fb.planes)
        enc_bd = getattr(self.venc, "bd", 8)
        src_bd = fb.pix_fmt.bit_depth if fb.pix_fmt else 8
        if enc_bd != src_bd:
            # FORMAT-filter role (work.c:1506): scale to the encoder's
            # bit depth
            sh = abs(enc_bd - src_bd)
            if enc_bd > src_bd:
                y, u, v = (p.astype(np.uint16) << sh for p in (y, u, v))
            else:
                y, u, v = ((p >> sh).astype(np.uint8) for p in (y, u, v))
        return y, u, v

    def _emit_video(self, au, fb, is_idr, qp, rc_state=None, mark=True):
        sd = fb.side_data or {}
        if sd and self._sei:
            # the source's HDR metadata as SEI NALs ahead of the access
            # unit (mastering display and content light on IDRs), and an
            # HEVC job's Dolby Vision RPU after it
            from .codecs.hdr import hdr_nals
            emit = {}
            if is_idr:
                emit.update({k: sd[k] for k in ("mastering_display",
                                                "content_light")
                             if k in sd})
            emit.update({k: sd[k] for k in ("hdr10plus_t35", "dovi_rpu")
                         if k in sd})
            pre, post = hdr_nals(emit, self._sei)
            au = pre + au + post
        ed = getattr(self.venc, "extradata", b"")
        if ed:
            # AV1's av1C: the mkv CodecPrivate
            fb.side_data = dict(fb.side_data or {})
            fb.side_data["codec_private"] = ed
        if is_idr and mark and rc_state is None:
            rc_state = checkpoint.rc_snapshot(self.rc)
        self.rc.update(len(au) * 8, qp, is_idr)
        self.stats["frames_out"] += 1
        self.stats["bytes_out"] += len(au)
        self.progress.tick()
        out = Buffer(track_kind="video", pts=fb.pts,
                     duration=fb.duration or 0)
        out.data = au
        out.side_data = dict(fb.side_data or {})
        out.frametype = 1 if is_idr else 0
        out.rc_state = rc_state
        return out

    def _encode(self, fb):
        y, u, v = self._planes(fb)
        if self.gop_parallel > 1:
            # buffer one window of keyframe-aligned chunks, then code it
            # (bounded memory, not the whole title)
            self._gp_frames.append(((y, u, v), fb))
            window = self.gop_parallel * max(1, min(self.venc.cfg.gop, 120))
            if len(self._gp_frames) >= window:
                return self._gp_flush()
            return []
        if isinstance(self.venc, _BFrameEncoderAdapter):
            self._b_fbs[self._b_disp] = fb
            self._b_disp += 1
            return self._emit_b(self.venc.push_display_frame(y, u, v))
        is_idr = (self.venc.frame_idx % self.venc.cfg.gop) == 0
        out = []
        if is_idr:
            # Drain the pipeline at GOP boundaries so rc.update() for every
            # frame of the previous GOP has run before this GOP's allocation.
            # Within a GOP, frame_qp intentionally lags one frame behind
            # update() — the price of overlapping device analysis of frame
            # N+1 with host entropy of frame N (encx264 lookahead role).
            while self._pend:
                out.append(self._finish_one())
        rc_state = checkpoint.rc_snapshot(self.rc) if is_idr else None
        qp = self.rc.frame_qp(is_idr)
        if not hasattr(self.venc, "begin_frame"):
            # the HEVC and AV1 walkers code a frame in one call
            au = self.venc.encode_frame(y, u, v, qp=qp)
            return out + [self._emit_video(au, fb,
                                           self.venc.last_frame_was_idr,
                                           qp, rc_state)]
        self._pend.append((self.venc.begin_frame(y, u, v, qp=qp), fb, qp,
                           is_idr, rc_state))
        if out:
            return out
        if len(self._pend) > 1:
            return [self._finish_one()]
        return []

    def _finish_one(self):
        p, fb, qp, is_idr, rc_state = self._pend.pop(0)
        au = self.venc.finish_frame(p)
        return self._emit_video(au, fb, is_idr, qp, rc_state)

    def _gp_flush(self):
        """Code the buffered window as G = min(gop_parallel, frames)
        keyframe-aligned GOPs and emit the access units in display order.
        A single-pass window takes the controller's current qp; a
        multipass bitrate job runs the two-pass GOP allocator per
        window."""
        from .parallel.gop import (encode_gop_parallel,
                                   encode_gop_parallel_2pass)
        from .parallel.mesh import make_mesh
        if not self._gp_frames:
            return []
        frames = [p for p, _fb in self._gp_frames]
        fbs = [fb for _p, fb in self._gp_frames]
        self._gp_frames = []
        G = max(1, min(self.gop_parallel, len(frames)))
        w, h = self.out_wh
        rc_state = checkpoint.rc_snapshot(self.rc)
        qp = int(self.rc.frame_qp(True))
        mesh = make_mesh(tile=1, device=self.device)
        log(f"gop-parallel: {len(frames)} frames as {G} GOPs over "
            f"{mesh.n} rank(s)")
        fps = self.venc.cfg.fps
        if self.multipass and self.target_kbps > 0:
            _, _, st = encode_gop_parallel_2pass(
                frames, w, h, self.target_kbps, G, fps=fps,
                qp1=min(51, qp + 6), device=self.device, mesh=mesh)
            frame_aus = st["frame_aus"]
        else:
            _, _, frame_aus = encode_gop_parallel(frames, w, h, qp, G,
                                                  fps=fps,
                                                  device=self.device,
                                                  mesh=mesh)
        out = []
        i = 0
        for aus in frame_aus:
            for k, au in enumerate(aus):
                out.append(self._emit_video(au, fbs[i], k == 0, qp,
                                            rc_state if i == 0 else None,
                                            mark=i == 0))
                i += 1
        return out

    def _emit_b(self, aus) -> list:
        """The walker's decode-order access units, each emitted against
        its display frame's timestamps (the muxers derive the cts
        offsets from pts against the decode-order clock)."""
        gop, qp = self.venc.cfg.gop, self.venc.cfg.qp
        return [self._emit_video(au, self._b_fbs.pop(d), d % gop == 0, qp)
                for d, au in aus]

    def work(self, buf):
        if buf.is_eof():
            out = []
            for fb in self.graph.flush():
                out += self._encode(fb)
            out += self._gp_flush()
            if isinstance(self.venc, _BFrameEncoderAdapter):
                out += self._emit_b(self.venc.flush())
            while self._pend:
                out.append(self._finish_one())
            for sid, enc in self.aencs.items():
                for pkt in enc.flush():
                    pkt.stream_id = sid
                    out.append(pkt)
            return out + [buf]
        if buf.track_kind == "video":
            out = []
            for fb in self.graph.work(buf):
                if not fb.is_eof():
                    out += self._encode(fb)
            return out
        if buf.track_kind == "audio":
            enc = self.aencs.get(buf.stream_id)
            out = []
            if enc is not None:
                for pkt in enc.process(buf):
                    pkt.stream_id = buf.stream_id
                    pkt.track_kind = "audio"
                    out.append(pkt)
            return out
        if buf.track_kind == "subtitle":
            spec = self.sub_specs.get(buf.stream_id - _SUB_SID0)
            if spec is None:
                return []
            if not spec.burn:
                return [buf]   # muxed subtitle track
            if getattr(buf, "sub_clear", False) or buf.planes is not None:
                # bitmap event / clear marker (PGS): blend layer
                self.graph.queue_subtitle(buf)
                return []
            from .subtitles.raster import render_text_rgba
            w, h, left, top = self.text_area
            rgba, (x0, y0) = render_text_rgba(buf.data.decode("utf-8"), w,
                                              h)
            ev = Buffer(track_kind="subtitle", pts=buf.pts, stop=buf.stop,
                        duration=buf.duration)
            ev.planes = [rgba]
            ev.rect = (x0 + left, y0 + top)
            self.graph.queue_subtitle(ev)
            return []
        return []


class _MuxStage(WorkObject):
    """Track fan-in + time-chunk interleave (muxcommon.c) driving the
    format adapter."""
    name = "mux"

    def __init__(self, adapter, aencs):
        super().__init__()
        self.adapter = adapter
        from .mux.common import Muxer
        self.muxer = Muxer(writer=None, kind="custom")
        self._tmap = {}

        def vid_write(b):
            adapter.write_video(b.data, b, idr=bool(b.frametype & 1))
        self._tmap[("video", None)] = self.muxer.add_track(write=vid_write)
        for sid in aencs:
            def aw(b, sid=sid):
                adapter.write_audio(sid, b)
            self._tmap[("audio", sid)] = self.muxer.add_track(write=aw)

    def work(self, buf):
        if buf.is_eof():
            self.muxer.finish()
            self.adapter.finalize()
            return []
        if buf.track_kind == "video":
            self.muxer.queue(self._tmap[("video", None)], buf)
        elif buf.track_kind == "audio":
            t = self._tmap.get(("audio", buf.stream_id))
            if t is not None:
                self.muxer.queue(t, buf)
        elif buf.track_kind == "subtitle":
            # tx3g/S_TEXT cues are sparse; the adapter writes them directly
            self.adapter.write_subtitle(buf.stream_id - _SUB_SID0, buf)
        return []


class _NullMux:
    """Sink for analysis passes (pass 1 writes no output file)."""

    def write_video(self, au, fb, idr):
        pass

    def write_audio(self, sid, pkt):
        pass

    def write_subtitle(self, k, buf):
        pass

    def finalize(self):
        pass


# ---------------------------------------------------------------------------
# audio stages (host code, as in the reference)
# ---------------------------------------------------------------------------
class _PcmDecoder:
    """PCM-in-container (little-endian s16) and DVD LPCM
    (declpcm.c:410 role: big-endian, 16/20/24-bit; the PS demuxer parses
    the substream header into TrackInfo + a bits byte in extradata)."""

    def __init__(self, ti):
        self.ti = ti
        self.dvd = ti.codec == "lpcm"
        self.bits = (ti.extradata[0] if self.dvd and ti.extradata
                     else 16)
        self._rem = b""

    def feed(self, buf: Buffer) -> list:
        if buf.data is None:
            return []
        ch = max(1, self.ti.channels)
        if not self.dvd:
            pcm = np.frombuffer(buf.data, "<i2").astype(np.float32) / 32768.0
        else:
            data = self._rem + bytes(buf.data)
            if self.bits == 16:
                n = len(data) // (2 * ch) * (2 * ch)
                self._rem = data[n:]
                pcm = np.frombuffer(data[:n], ">i2").astype(
                    np.float32) / 32768.0
            else:
                # DVD 20/24-bit group: per 2-sample-pair group, the MSB
                # 16 bits of 2*ch samples, then the LSB tail bytes
                gsz = 2 * ch * 2 + (ch if self.bits == 24 else ch // 2 or 1)
                n = len(data) // gsz * gsz
                self._rem = data[n:]
                g = np.frombuffer(data[:n], np.uint8).reshape(-1, gsz)
                hi = g[:, :2 * ch * 2].reshape(-1, 2 * ch, 2)
                s16 = (hi[:, :, 0].astype(np.int32) << 8) | hi[:, :, 1]
                s16 = np.where(s16 >= 32768, s16 - 65536, s16)
                pcm = (s16 / 32768.0).astype(np.float32).reshape(-1)
        pcm = pcm.reshape(-1, ch)
        out = Buffer(track_kind="audio").copy_props(buf)
        out.planes = [pcm]
        out.data = None
        if not out.duration and self.ti.sample_rate:
            # containers without per-block durations (mkv) would leave
            # the sync gap-filler thinking the clock never advanced
            out.duration = int(round(pcm.shape[0] * 90000
                                     / self.ti.sample_rate))
            out.stop = (out.pts + out.duration) \
                if out.pts is not None else None
        return [out]


class _CopyAudioDecoder:
    """Passthrough: compressed packets ride the sync layer unchanged."""

    def feed(self, buf: Buffer) -> list:
        return [buf]


class _AacPacketDecoder:
    """AAC-LC decode (audio/aacdec.py, decavcodec.c:367 role): one
    container packet = one access unit (mp4/mkv, ASC in extradata) or an
    ADTS byte stream (TS).  The 1024-sample filterbank delay is absorbed
    by dropping the first output frame and carrying each output on the
    previous packet's timestamp."""

    def __init__(self, ti):
        import collections
        self.dec = AACDecoder(ti.extradata or None)
        aot = getattr(self.dec, "aot", 2)
        if aot not in DECODABLE_AOTS:
            raise WorkError(f"aac: audio object type {aot} cannot be "
                            f"decoded (AAC-LC, object type 2, can)")
        self.ti = ti
        self._pend = b""
        self._adts = None
        self._pts_q = collections.deque()
        self._primed = False

    def feed(self, buf: Buffer) -> list:
        if buf.data is None:
            return []
        data = bytes(buf.data)
        if self._adts is None:
            self._adts = (len(data) >= 2 and data[0] == 0xFF
                          and (data[1] & 0xF0) == 0xF0)
            if self._adts and len(data) >= 3 and data[2] >> 6 != 1:
                raise WorkError(f"aac: ADTS profile {data[2] >> 6} cannot "
                                f"be decoded (AAC-LC, profile 1, can)")
        if self._adts:
            self._pend += data
            frames = []
            while True:
                h = self.dec.parse_adts_header(self._pend)
                if h is None:
                    i = self._pend.find(b"\xff", 1)   # resync on garbage
                    if i < 0:
                        self._pend = self._pend[-1:] \
                            if self._pend else b""
                        break
                    self._pend = self._pend[i:]
                    continue
                if len(self._pend) < h[1]:
                    break
                frames.append(self._pend[:h[1]])
                self._pend = self._pend[h[1]:]
        else:
            frames = [data]
        outs = []
        for k, fr in enumerate(frames):
            try:
                pcm = self.dec.decode_frame(fr)
            except AACUnsupported as e:   # a fault of the track
                raise WorkError(f"aac: {e}") from e
            except Exception as e:  # noqa: BLE001 — corrupt AU: skip
                log("aac decode error: %s" % e)
                continue
            dur = int(round(pcm.shape[0] * 90000 /
                            max(1, self.dec.sample_rate)))
            # AU k of an ADTS burst starts k frame-durations after the
            # packet pts; mp4/mkv deliver one AU per packet (k = 0)
            self._pts_q.append((buf.pts + k * dur)
                               if buf.pts is not None else None)
            if not self._primed:
                # drop the filterbank priming frame; each later output
                # carries the PREVIOUS AU's pts (1024-sample delay)
                self._primed = True
                continue
            pts = self._pts_q.popleft()
            out = Buffer(track_kind="audio").copy_props(buf)
            out.pts = pts
            out.duration = dur
            out.stop = (pts + dur) if pts is not None else None
            out.planes = [pcm]
            out.data = None
            outs.append(out)
        return outs


class _Ac3PacketDecoder:
    """AC-3 decode (audio/ac3dec.py — decavcodec.c AC-3 personality
    role): byte-stream sync on 0x0B77 syncframes, so DVD/TS packets may
    split or batch frames.  Each 1536-sample output takes the packet
    pts when a fresh packet starts a frame, else extrapolates."""

    def __init__(self, ti):
        from .audio.ac3dec import Ac3Decoder
        self.dec = Ac3Decoder()
        self.ti = ti
        self._next_pts = None

    def feed(self, buf: Buffer) -> list:
        if buf.data is None:
            return []
        if buf.pts is not None and not self.dec._buf:
            self._next_pts = buf.pts
        frames = self.dec.feed(bytes(buf.data))
        outs = []
        for pcm in frames:
            sr = max(1, self.dec.sample_rate)
            dur = int(round(pcm.shape[1] * 90000 / sr))
            out = Buffer(track_kind="audio").copy_props(buf)
            out.pts = self._next_pts
            out.duration = dur
            out.stop = (self._next_pts + dur) \
                if self._next_pts is not None else None
            out.planes = [np.ascontiguousarray(pcm.T)]
            out.data = None
            outs.append(out)
            if self._next_pts is not None:
                self._next_pts += dur
        return outs


class _TextCueDecoder:
    """In-stream text subtitle cues → plain text (dectx3gsub.c role for
    mp4 tx3g samples; mkv S_TEXT/UTF8 raw cues; S_TEXT/ASS block lines
    with the decssasub.c field split)."""

    def __init__(self, codec):
        self.codec = codec

    def parse(self, data: bytes) -> str:
        import re
        if self.codec in ("tx3g", "text"):
            if len(data) < 2:
                return ""
            n = int.from_bytes(data[:2], "big")
            txt = data[2:2 + n].decode("utf-8", "replace")
        elif self.codec in ("ass", "ssa"):
            # mkv block line: ReadOrder,Layer,Style,Name,4xMargin,
            # Effect,Text
            parts = data.decode("utf-8", "replace").split(",", 8)
            txt = parts[-1] if parts else ""
            txt = txt.replace("\\N", "\n").replace("\\n", "\n") \
                .replace("\\h", " ")
        else:                              # srt/subrip: raw cue text
            txt = data.decode("utf-8", "replace")
        txt = re.sub(r"<[^>]{1,64}>|\{\\[^}]{0,64}\}", "", txt)
        return txt.strip()


class _Mp2PacketDecoder:
    """MPEG-1 Layer I/II audio decode (audio/mp2dec.py — the DVB/DVD
    broadcast personality of decavcodec.c): byte-stream sync, 1152
    (or 384) samples per frame, same pts policy as _Ac3PacketDecoder."""

    def __init__(self, ti):
        from .audio.mp2dec import Mp2Decoder
        self.dec = Mp2Decoder()
        self.ti = ti
        self._next_pts = None

    def feed(self, buf: Buffer) -> list:
        if buf.data is None:
            return []
        if buf.pts is not None and not self.dec._buf:
            self._next_pts = buf.pts
        outs = []
        for pcm in self.dec.feed(bytes(buf.data)):
            sr = max(1, self.dec.sample_rate)
            dur = int(round(pcm.shape[0] * 90000 / sr))
            out = Buffer(track_kind="audio").copy_props(buf)
            out.pts = self._next_pts
            out.duration = dur
            out.stop = (self._next_pts + dur) \
                if self._next_pts is not None else None
            out.planes = [pcm]
            out.data = None
            outs.append(out)
            if self._next_pts is not None:
                self._next_pts += dur
        return outs


class _FlacPacketDecoder:
    """Streaming FLAC decode: one container packet = one FLAC frame
    (decavcodec.c audio personality role for FLAC inputs).  A track
    without STREAMINFO raises (the reference decodes nothing from it)."""

    def __init__(self, ti):
        from .audio.flac import FLAC_MARKER, FlacDecoder
        xd = ti.extradata or b""
        if not xd:
            raise WorkError("flac: the track carries no STREAMINFO, so it "
                            "cannot be decoded")
        if not xd.startswith(FLAC_MARKER):
            # mp4 dfLa carries the bare STREAMINFO block; mkv has fLaC + blocks
            xd = FLAC_MARKER + b"\x80\x00\x00\x22" + xd[-34:]
        self.dec = FlacDecoder(xd)
        self.ti = ti

    def feed(self, buf: Buffer) -> list:
        if buf.data is None:
            return []
        from .audio.flac import _BR
        pcm_i = self.dec._decode_frame(_BR(buf.data))
        bits = self.dec.bits or 16
        pcm = pcm_i.astype(np.float32) / float(1 << (bits - 1))
        out = Buffer(track_kind="audio").copy_props(buf)
        out.planes = [pcm]
        out.data = None
        return [out]


# decoded by libavcodec in the reference (decavcodec.c:192-347), which is
# not ported yet
_AV_AUDIO = ("eac3", "dts", "dca", "truehd", "mlp", "mp3", "vorbis", "opus")


def _make_audio_decoder(ti, spec=None):
    """The track's decoder.  Where the reference falls back (an AAC
    decoder that cannot start becomes passthrough; a codec it cannot
    decode becomes a passthrough that the chain then drops), the port
    raises with the codec's name."""
    if spec is not None and str(spec.encoder).startswith("copy"):
        # passthrough: keep the compressed packets intact (WORK_PASS
        # role) — decoding would hand PCM to a chain that forwards data
        return _CopyAudioDecoder()
    if ti.codec == "lpcm" and not ti.extradata:
        # an LPCM track without the DVD substream header that PSDemuxer
        # reads (TS stream type 0x80, Blu-ray LPCM, has a header of its
        # own): the reference decodes it as DVD LPCM, which it is not
        raise WorkError("lpcm: no DVD LPCM header on this track (Blu-ray "
                        "LPCM has no decoder)")
    if ti.codec in ("pcm_s16le", "lpcm"):
        return _PcmDecoder(ti)
    if ti.codec == "flac":
        return _FlacPacketDecoder(ti)
    if ti.codec == "aac":
        try:
            return _AacPacketDecoder(ti)
        except (IndexError, ValueError) as e:   # the ASC does not parse
            raise WorkError(f"aac: the decoder cannot start on this "
                            f"track ({e!r})") from e
    if ti.codec == "ac3":
        return _Ac3PacketDecoder(ti)
    if ti.codec in ("mp2", "mp1", "mpa"):
        return _Mp2PacketDecoder(ti)
    if ti.codec in _AV_AUDIO:
        _unported(f"{ti.codec} audio decoding (the libavcodec catalog, "
                  f"ROADMAP item 1.10)")
    raise WorkError(f"audio codec {ti.codec!r}: no decoder")


def _make_audio_encoder(spec, ti):
    """Audio chain per output track (resample/mixdown/gain/drc + encoder):
    AAC-LC, AC-3, FLAC and PCM encode natively (audio/*.py); MP3, Opus
    and Vorbis raise (the libavcodec catalog, a later slice)."""
    from .audio.chain import AudioChain
    return AudioChain(spec, ti)


# ---------------------------------------------------------------------------
# mux adapter
# ---------------------------------------------------------------------------
class _MuxAdapter:
    """Wraps MP4Writer/MKVWriter behind one write_video/write_audio/
    write_subtitle API (muxcommon.c role: track fan-in; interleave is the
    writers' concern).  With a checkpoint journal (``journal``) every
    sample written is journaled; ``replay`` writes a journaled one."""

    def __init__(self, job: Job, out_fi, audio_sel, src, aencs=None,
                 sub_specs=None):
        self.journal = None
        self.kind = job.mux
        self.aencs = aencs or {}
        path = job.file or "out.mp4"
        self._amap = {}
        self._smap = {}           # subtitle key → track index
        self._sub_last_end = {}   # tx3g gap filling (90 kHz)
        if job.vcodec in ("hevc_tpu", "x265", "hevc", "h265"):
            mux_vcodec = "hevc"
        elif job.vcodec in ("av1_tpu", "svt_av1", "av1"):
            mux_vcodec = "av1"
        elif job.vcodec in ("mpeg2", "mpeg4", "vp9", "vp8", "ffv1",
                            "prores", "theora"):
            mux_vcodec = job.vcodec      # lavc catalog: raw samples
        else:
            mux_vcodec = "h264"
        self._raw_video = mux_vcodec not in ("h264", "hevc", "av1")
        if self._raw_video and self.kind not in ("mkv", "webm"):
            raise WorkError(
                f"{mux_vcodec} output requires the mkv container")
        if self.kind in ("mkv", "webm"):
            from .mux.mkv import MKVWriter
            self.w = MKVWriter(path, webm=(self.kind == "webm"))
            self.vtrack = self.w.add_video_track(
                codec=mux_vcodec, width=out_fi.geometry.width,
                height=out_fi.geometry.height,
                fps=float(out_fi.vrate))
            for si, spec in audio_sel:
                ti = src.tracks[si]
                chain = self.aencs.get(si)
                priv = b""
                if chain is not None and chain.out_codec() == "flac":
                    from .audio.flac import FLAC_MARKER
                    priv = FLAC_MARKER + chain.extradata(initial=True)
                elif chain is not None and chain.out_codec() == "aac":
                    priv = chain.extradata()   # AudioSpecificConfig
                elif chain is not None and chain.out_codec() in (
                        "opus", "vorbis"):
                    priv = chain.extradata()   # passthrough: OpusHead /
                                               # Xiph lacing
                elif chain is not None and chain.is_passthrough():
                    priv = ti.extradata
                self._amap[si] = self.w.add_audio_track(
                    codec=chain.out_codec() if chain else ti.codec,
                    sample_rate=chain.sr_out if chain else ti.sample_rate,
                    channels=chain.out_channels if chain else ti.channels,
                    private=priv, language=ti.language)
        else:
            from .mux.mp4 import MP4Writer
            self.w = MP4Writer(path)
            self.vtrack = self.w.add_video_track(
                codec=mux_vcodec, width=out_fi.geometry.width,
                height=out_fi.geometry.height)
            # colr nclx from the title's signalled colorimetry (the
            # muxavformat.c track-setup analog; mdcv/clli follow from
            # side_data at write_video time)
            tcolor = dict(getattr(src, "color", None) or {})
            tcolor.update(job.color or {})
            self.w.tracks[self.vtrack].color = {
                "Primaries": tcolor.get("Primaries", 1),
                "Transfer": tcolor.get("Transfer", 1),
                "Matrix": tcolor.get("Matrix", 1),
                "Range": tcolor.get("Range", 1)}
            for si, spec in audio_sel:
                ti = src.tracks[si]
                chain = self.aencs.get(si)
                xd = b""
                if chain is not None and chain.out_codec() == "aac":
                    xd = chain.extradata()     # AudioSpecificConfig
                elif chain is not None and chain.out_codec() == "ac3":
                    xd = chain.extradata()     # dac3 payload
                    if not xd:
                        # passthrough: synthesize dac3 from track info
                        # (fscod/bsid/bsmod/acmod/lfeon packed fields)
                        fscod = {48000: 0, 44100: 1,
                                 32000: 2}.get(ti.sample_rate, 0)
                        acmod = {1: 1, 2: 2, 6: 7}.get(ti.channels, 2)
                        lfe = 1 if ti.channels == 6 else 0
                        v = (fscod << 22) | (8 << 17) | (acmod << 11) \
                            | (lfe << 10) | (11 << 5)   # ~192 kbps
                        xd = v.to_bytes(3, "big")
                elif chain is not None and chain.out_codec() == "opus":
                    # passthrough: dOps payload = OpusHead minus the
                    # 8-byte magic, version byte first (RFC 7845 /
                    # ISO-BMFF Opus)
                    oh = chain.extradata()
                    if len(oh) >= 19 and oh[:8] == b"OpusHead":
                        xd = b"\x00" + oh[9:]
                elif chain is not None and chain.out_codec() in (
                        "mp3", "vorbis"):
                    xd = chain.extradata()
                elif chain is not None and chain.is_passthrough():
                    xd = ti.extradata
                    if ti.codec == "aac" and not xd:
                        # ADTS sources carry no ASC: build AAC-LC
                        # AudioSpecificConfig from the track info
                        srates = [96000, 88200, 64000, 48000, 44100,
                                  32000, 24000, 22050, 16000, 12000,
                                  11025, 8000, 7350]
                        sfi = srates.index(ti.sample_rate) \
                            if ti.sample_rate in srates else 3
                        ch = max(1, min(7, ti.channels))
                        v = (2 << 11) | (sfi << 7) | (ch << 3)
                        xd = v.to_bytes(2, "big")
                self._amap[si] = self.w.add_audio_track(
                    codec=chain.out_codec() if chain else ti.codec,
                    sample_rate=chain.sr_out if chain else ti.sample_rate,
                    channels=chain.out_channels if chain else ti.channels,
                    extradata=xd, language=ti.language)
        for k, sspec in (sub_specs or {}).items():
            if sspec.burn:
                continue
            if self.kind in ("mkv", "webm"):
                self._smap[k] = self.w.add_subtitle_track(
                    codec="srt", language=sspec.language)
            else:
                self._smap[k] = self.w.add_subtitle_track(
                    codec="tx3g", language=sspec.language)
            self._sub_last_end[k] = 0
        if job.chapter_markers:
            for i, (start, name) in enumerate(getattr(src, "chapters", [])):
                title = job.chapter_names[i] \
                    if i < len(job.chapter_names) else name
                self.w.add_chapter(start, title or f"Chapter {i + 1}")
        self.metadata = dict(job.metadata)
        if hasattr(self.w, "metadata"):
            self.w.metadata = self.metadata

    def write_video(self, au: bytes, fb: Buffer, idr: bool, _journal=True):
        if _journal and self.journal is not None:
            self.journal.video(bytes(au), fb.pts, fb.duration, idr,
                               fb.side_data, getattr(fb, "rc_state", None))
        sd = fb.side_data or {}
        if sd and self.kind not in ("mkv", "webm"):
            t = self.w.tracks[self.vtrack]
            if "mastering_display" in sd and not t.mastering:
                t.mastering = sd["mastering_display"]
            if "content_light" in sd and not t.cll:
                t.cll = sd["content_light"]
        dur = fb.duration or 0
        annexb = not self._raw_video
        cp = sd.get("codec_private")
        if cp and self.kind in ("mkv", "webm") \
                and not self.w.tracks[self.vtrack].private:
            # catalog encoders (theora/mpeg4/...) carry their config in
            # extradata — MKV CodecPrivate, set before the first sample
            self.w.tracks[self.vtrack].private = cp
        if self.kind in ("mkv", "webm"):
            # the H.264 CodecPrivate (avcC) comes from the first sample's
            # SPS/PPS, before the track header is written
            self.w.write_sample(self.vtrack, au, pts_90k=fb.pts or 0,
                                duration_90k=dur, sync=idr, annexb=annexb)
        else:
            # decode-order samples: cts offset = display pts vs the
            # decode-order clock (non-zero only for B reorder; ctts v1)
            vdts = getattr(self, "_vdts", 0)
            cts = (fb.pts - vdts) if fb.pts is not None else 0
            self._vdts = vdts + dur
            self.w.write_sample(self.vtrack, au, duration=dur, sync=idr,
                                cts_offset=cts, annexb=annexb)

    @staticmethod
    def _strip_adts(data: bytes) -> bytes:
        """ADTS framing → raw AAC AUs (the aac_adtstoasc BSF role):
        containers index access units, not the self-framing stream."""
        out = bytearray()
        i = 0
        n = len(data)
        while i + 7 <= n and data[i] == 0xFF and \
                (data[i + 1] & 0xF0) == 0xF0:
            ln = ((data[i + 3] & 3) << 11) | (data[i + 4] << 3) \
                | (data[i + 5] >> 5)
            hdr = 7 if (data[i + 1] & 1) else 9    # +CRC
            if ln < hdr or i + ln > n:
                break
            out += data[i + hdr:i + ln]
            i += ln
        return bytes(out) if i and i == n else data

    def replay(self, rec):
        """Re-apply one checkpoint-journal record (resume path)."""
        if rec[0] == "v":
            _tag, au, pts, dur, idr, sd = rec
            fb = Buffer(track_kind="video", pts=pts, duration=dur)
            fb.side_data = dict(sd)
            self.write_video(au, fb, idr, _journal=False)
        elif rec[0] == "a":
            _tag, sid, data, pts, dur, stop = rec
            b = Buffer(track_kind="audio", pts=pts, duration=dur)
            b.data = data
            b.stop = stop
            self.write_audio(sid, b, _journal=False)
        elif rec[0] == "s":
            _tag, k, data, pts, dur, stop = rec
            b = Buffer(track_kind="subtitle", pts=pts, duration=dur)
            b.data = data
            b.stop = stop
            self.write_subtitle(k, b, _journal=False)

    def write_audio(self, sid: int, pkt: Buffer, _journal=True):
        tr = self._amap.get(sid)
        if tr is None or pkt.data is None:
            return
        if _journal and self.journal is not None:
            self.journal.audio(sid, bytes(pkt.data), pkt.pts, pkt.duration,
                               pkt.stop)
        data = pkt.data
        tcodec = self.w.tracks[tr]
        if getattr(tcodec, "codec", getattr(tcodec, "codec_id", "")) \
                in ("aac", "A_AAC"):
            data = self._strip_adts(bytes(data))
        if self.kind in ("mkv", "webm"):
            self.w.write_sample(tr, data, pts_90k=pkt.pts or 0,
                                duration_90k=pkt.duration or 0)
        else:
            t = self.w.tracks[tr]
            dur = (pkt.duration or 0) * t.timescale // CLOCK
            self.w.write_sample(tr, data, duration=dur)

    def write_subtitle(self, k: int, buf: Buffer, _journal=True):
        tr = self._smap.get(k)
        if tr is None or buf.data is None:
            return
        if _journal and self.journal is not None:
            self.journal.subtitle(k, bytes(buf.data), buf.pts, buf.duration,
                                  buf.stop)
        text = buf.data
        pts = buf.pts or 0
        dur = buf.duration or 0
        if self.kind in ("mkv", "webm"):
            self.w.write_sample(tr, text, pts_90k=pts, duration_90k=dur)
            return
        # mp4 tx3g: consecutive samples; gaps carry empty cues and an
        # OVERLAPPING cue is repaired by trimming its start to the
        # previous cue's end (sync.c:1162 subtitle-overlap role — the
        # tx3g sample model cannot express simultaneous cues)
        last = self._sub_last_end.get(k, 0)
        if pts > last:
            self.w.write_sample(tr, b"\x00\x00", duration=pts - last)
        elif pts < last:
            dur = max(0, (pts + dur) - last)
            pts = last
            if dur == 0:
                return
        sample = len(text).to_bytes(2, "big") + text
        self.w.write_sample(tr, sample, duration=dur)
        self._sub_last_end[k] = pts + dur

    def finalize(self):
        # late extradata (FLAC STREAMINFO carries final MD5/total-samples;
        # mp4 writes sample entries in moov at finalize so this is exact)
        if self.kind not in ("mkv", "webm"):
            for si, tr in self._amap.items():
                chain = self.aencs.get(si)
                if chain is not None:
                    xd = chain.extradata()
                    if xd:
                        self.w.tracks[tr].extradata = xd
        self.w.finalize()
        if self.journal is not None:
            self.journal.close(complete=True)
