"""HandBrakeCLI analog (reference: test/test.c — ~200 flags over the
preset/job machinery; this implements the core set).

Flow matches test.c main (test.c:517): preset prep → scan → on SCANDONE
build job from preset + CLI overrides → add → start → poll state.

The counterpart of ``handbrake_tpu/cli/__main__.py``: the same parser,
plus ``--device {cuda,cpu}`` (default cuda) for where the job runs.
The audio options take comma lists, one value a track of ``-a`` (the
last value repeats), as HandBrakeCLI's do; a single value gives every
track the same setting, as the reference's parser does.  ``--bframes N``
codes IB..BP groups with the host walker (with ``-q``; a bitrate target
raises).  ``--checkpoint`` journals the job to ``<dest>.ckpt`` and
``--resume`` continues a killed job from it; ``--gop-parallel N`` codes
G = min(N, frames) keyframe-aligned GOPs a window, also with
``--two-pass -b``; ``--tile-parallel N`` runs nlmeans in N row tiles.
Both spread over the ranks when torchrun starts the CLI on several
cards (``parallel/mesh.py``): rank 0 runs the job and its exit code is
the job's, the other ranks serve its work items and exit 0; one rank
runs the GOPs as a loop and nlmeans untiled.  ``-e x265`` (Main 10
with ``--encoder-profile main10``) and ``-e svt_av1`` code HEVC and AV1
on the host walkers with their motion search on the device; they take
no ``--bframes`` and no ``--gop-parallel``.  The libavcodec audio
encoders mp3, opus and vorbis raise NotImplementedError, as do unported
filters, codecs and containers.

Usage:
  python -m handbrake_tpu_torch.cli -i in.mp4 -o out.mkv [options]
  torchrun --standalone --nproc-per-node 4 -m handbrake_tpu_torch.cli \
      -i in.mp4 -o out.mp4 --gop-parallel 4 [options]
  python -m handbrake_tpu_torch.cli -i src --scan --json
  python -m handbrake_tpu_torch.cli --preset-list
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from ..hb import Handle
from ..job import schema as S
from ..job.presets import (builtin_presets, flatten, import_preset_file,
                           preset_search, preset_to_job)
from ..job.schema import AudioJobTrack, FilterSpec, Job, RangeSpec
from ..parallel.mesh import init_world
from ..utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="handbrake-tpu-torch",
        description="PyTorch/CUDA transcoder (HandBrakeCLI-compatible core)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the job runs (default: the CUDA card)")
    # source
    p.add_argument("-i", "--input", help="source file/directory")
    p.add_argument("-t", "--title", type=int, default=0)
    p.add_argument("--scan", action="store_true",
                   help="scan only, print titles")
    p.add_argument("--json", action="store_true",
                   help="machine output for scan/progress")
    p.add_argument("--previews", type=int, default=10)
    # destination
    p.add_argument("-o", "--output", help="destination file")
    p.add_argument("-f", "--format", choices=["mp4", "mkv", "webm"],
                   help="container (default from extension)")
    p.add_argument("-m", "--markers", action="store_true",
                   help="chapter markers")
    # presets
    p.add_argument("--preset", "-Z", dest="preset",
                   help="preset name (see --preset-list)")
    p.add_argument("--preset-list", action="store_true")
    p.add_argument("--preset-import-file")
    p.add_argument("--queue-import-file",
                   help="JSON list of job dicts to run in order")
    # video
    p.add_argument("-e", "--encoder",
                   help="video encoder (h264_tpu, ...)")
    p.add_argument("-q", "--quality", type=float,
                   help="constant quality (CRF-like)")
    p.add_argument("-b", "--vb", type=int, help="video bitrate kbps")
    p.add_argument("--two-pass", action="store_true")
    p.add_argument("-x", "--encopts", default=None,
                   help="encoder options string, e.g. keyint=120:cabac=1")
    p.add_argument("--comb-detect", nargs="?", const="default",
                   default=None, help="combing detection (comb_detect.c)")
    p.add_argument("--colorspace", default=None,
                   help="colorspace filter preset (bt709/bt2020/...)")
    p.add_argument("--encoder-preset", default=None)
    p.add_argument("--encoder-profile", default=None)
    p.add_argument("--encoder-level", default=None)
    p.add_argument("--gop-parallel", type=int, default=0,
                   help="code each window as min(N, frames) keyframe-"
                        "aligned GOPs over torchrun's ranks (h264)")
    p.add_argument("--tile-parallel", type=int, default=0,
                   help="NLMeans row tiles over min(N, ranks) ranks "
                        "(taskset analog); one rank runs it untiled")
    p.add_argument("--bframes", type=int, default=0,
                   help="B-frames between anchors (h264; IB..BP GOP "
                        "via the host walker, x264 bframes role)")
    p.add_argument("--checkpoint", action="store_true",
                   help="journal muxed samples + RC state to "
                        "<dest>.ckpt at every GOP boundary")
    p.add_argument("--resume", action="store_true",
                   help="resume a killed encode from <dest>.ckpt "
                        "(implies --checkpoint)")
    # picture
    p.add_argument("-w", "--width", type=int)
    p.add_argument("-l", "--height", type=int)
    p.add_argument("--crop", help="top:bottom:left:right")
    p.add_argument("--non-anamorphic", action="store_const", const=0,
                   dest="anamorphic")
    p.add_argument("--auto-anamorphic", "--strict-anamorphic",
                   action="store_const", const=1, dest="anamorphic")
    p.add_argument("--loose-anamorphic", action="store_const", const=2,
                   dest="anamorphic")
    p.add_argument("--custom-anamorphic", action="store_const", const=3,
                   dest="anamorphic")
    p.add_argument("--modulus", type=int, default=2)
    p.add_argument("--maxWidth", "--max-width", type=int, default=0,
                   dest="max_width")
    p.add_argument("--maxHeight", "--max-height", type=int, default=0,
                   dest="max_height")
    p.add_argument("--pixel-aspect", help="PARX:PARY (custom anamorphic)")
    p.add_argument("--keep-display-aspect", action="store_true",
                   default=True)
    p.add_argument("--no-keep-display-aspect", dest="keep_display_aspect",
                   action="store_false")
    p.add_argument("--auto-crop", action="store_true", default=True)
    p.add_argument("--no-auto-crop", dest="auto_crop",
                   action="store_false")
    # rate control
    p.add_argument("-r", "--rate", help="framerate (e.g. 29.97 or 30000/1001)")
    p.add_argument("--cfr", action="store_true")
    p.add_argument("--pfr", action="store_true")
    p.add_argument("--vfr", action="store_true")
    # filters
    p.add_argument("--deinterlace", nargs="?", const="default")
    p.add_argument("--decomb", nargs="?", const="default")
    p.add_argument("--detelecine", nargs="?", const="default")
    p.add_argument("--denoise", "--hqdn3d", dest="hqdn3d", nargs="?",
                   const="medium")
    p.add_argument("--nlmeans", nargs="?", const="medium")
    p.add_argument("--bm3d", nargs="?", const="medium")
    p.add_argument("--deblock", nargs="?", const="medium")
    p.add_argument("--deband", nargs="?", const="medium")
    p.add_argument("--unsharp", nargs="?", const="medium")
    p.add_argument("--lapsharp", nargs="?", const="medium")
    p.add_argument("--chroma-smooth", nargs="?", const="medium")
    p.add_argument("--grayscale", action="store_true")
    p.add_argument("--rotate", help="angle=90|180|270[:hflip=1]")
    p.add_argument("--pad", help="width:height[:color]")
    # audio
    p.add_argument("-a", "--audio", help="track list, e.g. 1,2 or none")
    p.add_argument("-E", "--aencoder", default="aac",
                   help="audio encoders, one a track: aac, ac3, flac, pcm "
                        "or copy[:codec]")
    p.add_argument("-B", "--ab", default="160",
                   help="audio bit rates in kb/s, one a track")
    p.add_argument("-6", "--mixdown", default="stereo",
                   help="mixdowns, one a track (mono, stereo, dpl2, "
                        "5point1, ...)")
    p.add_argument("-R", "--arate", default=None,
                   help="audio samplerates (kHz or Hz), one a track")
    p.add_argument("--gain", default="0",
                   help="audio gains in dB, one a track")
    p.add_argument("--drc", default="0",
                   help="dynamic range compression (1.0-4.0), one a "
                        "track")
    p.add_argument("--acompressor", type=float, default=0.0,
                   help="compressor ratio (acompressor)")
    p.add_argument("--agate", type=float, default=0.0,
                   help="gate threshold dB (agate)")
    # subtitles (decsrtsub.c / deccc608sub.c roles)
    p.add_argument("-s", "--subtitle",
                   help="comma list of 1-based scanned subtitle tracks "
                        "(or 'cc' for closed captions)")
    p.add_argument("--subtitle-burned", type=int, default=0,
                   help="1-based index into -s to burn in (0=none)")
    p.add_argument("--srt-file", help="comma list of .srt files to import")
    p.add_argument("--srt-lang", default="und",
                   help="comma list of ISO-639 codes for --srt-file")
    p.add_argument("--srt-offset", default="0",
                   help="comma list of ms offsets for --srt-file")
    p.add_argument("--srt-burn", type=int, default=0,
                   help="1-based index into --srt-file to burn in (0=none)")
    p.add_argument("--srt-default", type=int, default=0,
                   help="1-based index of the default subtitle track")
    # range
    p.add_argument("--start-at", help="frame:N | seconds:N")
    p.add_argument("--stop-at", help="frame:N | seconds:N (duration)")
    p.add_argument("-c", "--chapters", help="chapter range, e.g. 1-3")
    p.add_argument("-v", "--verbose", type=int, default=1, nargs="?")
    return p


def list_presets():
    def walk(items, depth=0):
        for it in items:
            if it.get("Folder"):
                print("  " * depth + f"{it['PresetName']}/")
                walk(it.get("ChildrenArray", []), depth + 1)
            else:
                print("  " * depth + f"{it['PresetName']}: "
                      + it.get("PresetDescription", ""))
    walk(builtin_presets())


def check_ported(args):
    """Raise NotImplementedError for options whose paths are later
    slices of the port."""
    aencoders = _per_track(args.aencoder, 1)
    if any(e in ("mp3", "opus", "vorbis") for e in aencoders):
        raise NotImplementedError("audio encoders mp3, opus and vorbis (-E) "
                                  "are not ported yet")


def _per_track(value, n: int) -> list:
    """A comma list of an audio option as n values, one a track, the last
    value repeating (HandBrakeCLI's rule)."""
    vals = [v.strip() for v in str(value).split(",")]
    return vals + vals[-1:] * (n - len(vals))


def _samplerate(v: str) -> int:
    if not v or v == "auto":
        return 0
    f = float(v)
    return int(f * 1000) if f < 200 else int(f)


def apply_cli_overrides(job: Job, args) -> Job:
    if args.output:
        job.file = args.output
    if args.format:
        job.mux = args.format
    elif job.file and "." in job.file:
        ext = job.file.rsplit(".", 1)[1].lower()
        job.mux = {"mkv": "mkv", "webm": "webm"}.get(ext, "mp4")
    if args.encoder:
        job.vcodec = args.encoder
    if args.quality is not None:
        job.quality, job.vbitrate = args.quality, None
    if args.vb:
        job.quality, job.vbitrate = None, args.vb
        job.multipass = bool(args.two_pass)
    if args.encoder_preset:
        job.encoder_preset = args.encoder_preset
    if args.encoder_profile:
        job.encoder_profile = args.encoder_profile
    if args.encoder_level:
        job.encoder_level = args.encoder_level
    if args.gop_parallel:
        job.gop_parallel = args.gop_parallel
    if args.bframes:
        job.bframes = args.bframes
    if args.encopts:
        job.encoder_options = args.encopts
    if args.tile_parallel:
        job.tile_parallel = args.tile_parallel
    if args.checkpoint or args.resume:
        job.checkpoint = True
    if args.resume:
        job.resume = True
    if args.markers:
        job.chapter_markers = True

    fmap = {f.id: f for f in job.filters}

    def set_filter(fid, settings):
        fmap[fid] = FilterSpec(fid, settings)

    from ..job import param
    if args.detelecine:
        set_filter(S.FILTER_DETELECINE, param.generate_filter_settings(
            S.FILTER_DETELECINE, args.detelecine))
    if args.decomb:
        set_filter(S.FILTER_DECOMB, param.generate_filter_settings(
            S.FILTER_DECOMB, args.decomb))
    if args.deinterlace:
        set_filter(S.FILTER_YADIF, param.generate_filter_settings(
            S.FILTER_YADIF, args.deinterlace))
    if args.hqdn3d:
        set_filter(S.FILTER_DENOISE, param.generate_filter_settings(
            S.FILTER_DENOISE, args.hqdn3d))
    if args.nlmeans:
        set_filter(S.FILTER_NLMEANS, param.generate_filter_settings(
            S.FILTER_NLMEANS, args.nlmeans))
    if args.bm3d:
        set_filter(S.FILTER_BM3D, param.generate_filter_settings(
            S.FILTER_BM3D, args.bm3d))
    if args.deblock:
        set_filter(S.FILTER_DEBLOCK, param.generate_filter_settings(
            S.FILTER_DEBLOCK, args.deblock))
    if args.deband:
        set_filter(S.FILTER_DEBAND, param.generate_filter_settings(
            S.FILTER_DEBAND, args.deband))
    if args.unsharp:
        set_filter(S.FILTER_UNSHARP, param.generate_filter_settings(
            S.FILTER_UNSHARP, args.unsharp))
    if args.lapsharp:
        set_filter(S.FILTER_LAPSHARP, param.generate_filter_settings(
            S.FILTER_LAPSHARP, args.lapsharp))
    if args.chroma_smooth:
        set_filter(S.FILTER_CHROMA_SMOOTH, param.generate_filter_settings(
            S.FILTER_CHROMA_SMOOTH, args.chroma_smooth))
    if args.comb_detect:
        set_filter(S.FILTER_COMB_DETECT, param.generate_filter_settings(
            S.FILTER_COMB_DETECT, args.comb_detect))
    if args.colorspace:
        set_filter(S.FILTER_COLORSPACE, param.generate_filter_settings(
            S.FILTER_COLORSPACE, args.colorspace))
    if args.grayscale:
        set_filter(S.FILTER_GRAYSCALE, {})
    if args.rotate:
        set_filter(S.FILTER_ROTATE, param._parse_custom(args.rotate))
    if args.pad:
        parts = args.pad.split(":")
        st = {"width": int(parts[0]), "height": int(parts[1])}
        if len(parts) > 2:
            st["color"] = parts[2]
        set_filter(S.FILTER_PAD, st)
    # geometry overrides
    cs = fmap.get(S.FILTER_CROP_SCALE)
    if cs is None and (args.width or args.height or args.crop):
        cs = FilterSpec(S.FILTER_CROP_SCALE, {})
        fmap[S.FILTER_CROP_SCALE] = cs
    if cs is not None:
        if args.crop:
            t, b, lft, r = (int(x) for x in args.crop.split(":"))
            cs.settings.update({"crop-top": t, "crop-bottom": b,
                                "crop-left": lft, "crop-right": r})
        if args.width:
            cs.settings["width"] = args.width
        if args.height:
            cs.settings["height"] = args.height
    if getattr(args, "anamorphic", None) is not None:
        job.anamorphic_mode = args.anamorphic
        job.modulus = args.modulus
        job.max_width = args.max_width
        job.max_height = args.max_height
        job.keep_display_aspect = args.keep_display_aspect
        if args.pixel_aspect:
            pn, pd = args.pixel_aspect.split(":")
            job.par_num, job.par_den = int(pn), int(pd)
    # framerate
    if args.cfr or args.pfr or args.vfr or args.rate:
        mode = 1 if args.cfr else 2 if args.pfr else 0
        st = {"mode": mode}
        if args.rate:
            if "/" in args.rate:
                n, d = args.rate.split("/")
                st["rate-num"], st["rate-den"] = int(n), int(d)
            else:
                f = float(args.rate)
                if abs(f - round(f)) < 1e-9:
                    st["rate-num"], st["rate-den"] = int(round(f)), 1
                else:
                    st["rate-num"] = int(round(f * 1001))
                    st["rate-den"] = 1001
        set_filter(S.FILTER_VFR, st)
    job.filters = sorted(fmap.values(),
                         key=lambda f: S.FILTER_ORDER.index(f.id)
                         if f.id in S.FILTER_ORDER else 999)

    # audio
    if args.audio == "none":
        job.audio = []
    elif args.audio:
        tracks = [int(x) - 1 for x in args.audio.split(",")]
        n = len(tracks)
        enc, ab, mix = (_per_track(v, n) for v in (args.aencoder, args.ab,
                                                  args.mixdown))
        rate = _per_track(args.arate or "", n)
        gain, drc = _per_track(args.gain, n), _per_track(args.drc, n)
        job.audio = [AudioJobTrack(track=t, encoder=enc[i],
                                   bitrate=int(ab[i]), mixdown=mix[i],
                                   samplerate=_samplerate(rate[i]),
                                   gain=float(gain[i]), drc=float(drc[i]),
                                   compressor=args.acompressor,
                                   gate=args.agate)
                     for i, t in enumerate(tracks)]
    # subtitles
    if args.srt_file:
        from ..job.schema import SubtitleJobTrack
        files = args.srt_file.split(",")
        langs = (args.srt_lang or "und").split(",")
        offs = (args.srt_offset or "0").split(",")
        job.subtitles = []
        for i, f in enumerate(files):
            ext = f.rsplit(".", 1)[-1].lower()
            fmt = {"ass": "SSA", "ssa": "SSA", "vtt": "VTT"}.get(ext, "SRT")
            job.subtitles.append(SubtitleJobTrack(
                track=-1, import_file=f, import_format=fmt,
                language=langs[i] if i < len(langs) else "und",
                offset=int(offs[i]) if i < len(offs) else 0,
                burn=(args.srt_burn == i + 1),
                default=(args.srt_default == i + 1)))

    # range
    if args.chapters:
        a, _, b = args.chapters.partition("-")
        job.range = RangeSpec("chapter", int(a), int(b or a))
    if args.start_at or args.stop_at:
        kind, start, stop = "frame", 1, 0
        if args.start_at:
            k, v = args.start_at.split(":")
            kind = "time" if k in ("seconds", "duration", "time") else "frame"
            start = int(float(v)) + (1 if kind == "frame" else 0)
        if args.stop_at:
            k, v = args.stop_at.split(":")
            kind = "time" if k in ("seconds", "duration", "time") else "frame"
            stop = start + int(float(v)) - (1 if kind == "frame" else 0)
        job.range = RangeSpec(kind, start, stop)
    return job


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    check_ported(args)
    if args.preset_list:
        list_presets()
        return 0
    resolve_device(args.device)     # no card for "cuda": raise, here
    world = init_world(args.device)  # torchrun's ranks, if it started us
    if world is None:
        return run(args)
    if world.rank != 0:
        world.serve()
        return 0
    try:
        return run(args)
    finally:
        world.close()


def run(args) -> int:
    """The job (or scan, or queue) of parsed arguments; its exit code."""
    if args.queue_import_file:
        # run a saved queue: JSON list of job dicts (the Worker-process
        # queue import, test.c --queue-import-file role)
        import json as _json

        from ..job.schema import Job as _Job
        from ..work import do_job as _do_job
        with open(args.queue_import_file) as f:
            items = _json.load(f)
        if isinstance(items, dict):
            items = [items]
        rc = 0
        for i, d in enumerate(items):
            jd = d.get("Job", d)
            job = _Job.from_json(jd)
            print(f"queue job {i + 1}/{len(items)}: {job.path} -> "
                  f"{job.file}")
            stats = _do_job(job, device=args.device)
            if stats.get("error"):
                print(f"job {i + 1} failed: {stats}", file=sys.stderr)
                rc = 3
        return rc
    if not args.input:
        print("missing -i/--input", file=sys.stderr)
        return 1

    h = Handle(verbose=args.verbose or 0, device=args.device)
    h.scan(args.input, args.title, preview_count=args.previews)
    while h.get_state()["State"] != "SCANDONE":
        time.sleep(0.05)
    titles = h.titles
    if isinstance(h.scan_error, NotImplementedError):
        raise h.scan_error
    if not titles:
        print("no valid titles found", file=sys.stderr)
        return 2
    if args.scan:
        if args.json:
            print(h.get_title_set_json())
        else:
            for t in titles:
                print(f"+ title {t.index}: {t.path}")
                print(f"  + size: {t.width}x{t.height}, "
                      f"{t.vrate_num / t.vrate_den:.3f} fps, "
                      f"codec {t.video_codec}")
                print(f"  + autocrop: {'/'.join(map(str, t.crop))}")
                print(f"  + duration: {t.duration // 90000}s "
                      f"({t.nframes} frames)")
                for a in t.audio:
                    print(f"  + audio: {a.track + 1}, {a.codec} "
                          f"{a.sample_rate}Hz {a.channels}ch")
                for c in t.chapters:
                    print(f"  + chapter: {c.name}")
        return 0
    if not args.output:
        print("missing -o/--output", file=sys.stderr)
        return 1

    title = titles[0] if args.title == 0 else next(
        (t for t in titles if t.index == args.title), titles[0])
    preset = None
    if args.preset_import_file:
        tree = import_preset_file(args.preset_import_file)
        preset = preset_search(args.preset, tree) if args.preset \
            else (flatten(tree) or [None])[0]
    elif args.preset:
        preset = preset_search(args.preset)
        if preset is None:
            print(f"unknown preset {args.preset!r}", file=sys.stderr)
            return 1
    if preset is None:
        preset = preset_search("Fast 1080p30") or {}
    job = preset_to_job(title, preset)
    job = apply_cli_overrides(job, args)
    if args.subtitle:
        # map scanned subtitle indexes to demux tracks / the CC tap
        from ..job.schema import SubtitleJobTrack
        job.subtitles = list(job.subtitles)
        for i, tok in enumerate(
                x.strip() for x in args.subtitle.split(",") if x.strip()):
            burn = (args.subtitle_burned == i + 1)
            st = None
            if tok.lower() != "cc":
                idx = int(tok) - 1
                st = title.subtitles[idx] \
                    if 0 <= idx < len(title.subtitles) else None
            if tok.lower() == "cc" or (st is not None
                                       and st.source == "cc"):
                job.subtitles.append(SubtitleJobTrack(
                    cc=True, burn=burn,
                    language=st.language if st else "und"))
            else:
                demux_idx = sum(1 for s2 in title.subtitles[:idx]
                                if s2.source != "cc")
                job.subtitles.append(SubtitleJobTrack(
                    track=demux_idx, burn=burn,
                    language=st.language if st else "und"))
    h.add(job)
    h.start()
    last = -1.0
    while True:
        st = h.get_state()
        if st["State"] == "WORKDONE":
            break
        if st["State"] == "WORKING":
            wp = st["Working"]
            if wp["Progress"] != last:
                last = wp["Progress"]
                if args.json:
                    print(json.dumps(st), flush=True)
                else:
                    print(f"\rEncoding: {wp['Progress'] * 100:5.1f} % "
                          f"({wp['Rate']:.1f} fps, avg "
                          f"{wp['RateAvg']:.1f} fps, ETA "
                          f"{wp['ETASeconds']}s)", end="", flush=True)
        time.sleep(0.1)
    if not args.json:
        print()
    err = h.work_wait()
    if isinstance(h.work_exception, NotImplementedError):
        raise h.work_exception
    if err:
        print(f"encode failed with error {err}", file=sys.stderr)
        return 3
    print(f"Encode done: {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
