#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``handbrake_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (none is caught; any failure exits non-zero before the last line):

1. Build the deblock kernel (``csrc/deblock264.cu``, nvcc, sm_90a), the
   hqdn3d kernel (``csrc/hqdn3d.cu``, nvcc, sm_90a), the resample kernel
   (``csrc/resample.cu``, nvcc, sm_90a, ``--fmad=false``, a library for
   each pair of 8- or 16-bit samples in and out), the native
   slice coder (``native/hb264.cpp``, g++), the native H.264 decoder
   (``native/hbdec264.cpp``, g++) and the native MJPEG decoder
   (``native/hbdecmjpeg.cpp``, g++), all at once.
2. Hold the deblock kernel (planes and per-MB side data in; it derives
   bS itself) against its plain PyTorch version, ``deblock_plain`` on
   ``compute_bs``, on the card, bit for bit: random planes with intra
   MBs at 120x68 (1080p), 1x1, 3x7, 8x2, 1x68, 120x1 and 240x135 (2160p)
   MBs, 120x51 (1920x816, the letterbox job's coded size), both
   ``with_strong`` variants, and 512x270 (4320p) with
   ``with_strong=False``; 1080p with ``mb_intra=None``; and an
   all-filtering 1080p input (every edge filters), both variants.  Show
   that the wrapper refuses a frame above its size limit.  Time
   the kernel alone (CUDA events around 25 back-to-back launches with
   the arguments prepared first), the wrapper call (events around each
   single call) and the plain version, on the random 1080p input.
3. Drive the main path: a 1920x1080 High-profile encode (CABAC, in-loop
   deblock, 8x8 transform) of 33 synthetic frames (IDR + 32 P) with
   ``dispatch_batch=8``, pipelined as ``bench.py`` drives it, after a
   short warm-up encode.  The stream must equal the (also warm)
   ``dispatch_batch=1`` stream, its first 3 frames must
   equal the port's ``device="cpu"`` stream, and the deblock kernel must
   have launched once per analyzed P frame.
4. Time the kernel on a main-path P frame's own inputs: one analyzer
   call on the clip's next frame against the serial drive's references;
   its unfiltered recon, mv, nnz and t8 at qp 26 go to the kernel, whose
   output must equal the analyzer's and the plain version's.
5. Drive the job path, in-process, into a temporary directory:
   (a) a 3840x2160 y4m of 33 ``make_clip`` frames at 3840x1608 between
   black bars of 276 rows (2.39:1 film in a 16:9 frame) through the CLI,
   ``cli.__main__.main(["-i", src, "-o", out, "-e", "h264", "-q", "28",
   "--encoder-profile", "high"])``, default preset ``Fast 1080p30`` and
   device: the scan must autocrop the bars exactly, the mp4 (read back
   with the port's ``MP4Demuxer``) must hold 33 samples at the preset's
   1920x804 with an avcC, deblock264 must have launched once per
   analysed P frame, and the first 3 samples must equal the stream of
   the port's CPU encoder (its plain deblock) on the planes and qp the
   job's encoder was given, and the first 3 samples must equal, byte
   for byte, those of the port's CPU run of the same job through the CLI
   (``--device cpu``) on the source's first 3 frames; (b) the port's
   ``CropScaleFilter`` on (a)'s first frame with (a)'s settings, on the
   card and on the CPU: every plane equal, the fraction of samples that
   differ printed; the resample kernel (``csrc/resample.cu``) against its
   plain version on the card, bit for bit: (a)'s planes (3840x1608 luma
   to 1920x804, chroma with its siting shift), odd sizes and up-scales,
   with lanczos, bicubic, bilinear and point, 8 and 10 bits, the DVD
   upscales to 1080p (720x480 to 1440x1080, 720x576 to 1920x1080, luma
   and chroma: planes 720 and 360 wide, four lanes in the vertical
   order), and ``RS_RAGGED``: tiles one more and one less than a tile
   multiple, odd pitches, 16-bit output from 8-bit input, 8x down
   lanczos; (c)
   a 1920x1080 y4m of 33 ``make_clip`` frames through ``work.do_job``
   (H.264 High, quality 26, mp4, no crop/scale): its samples, as annex-B,
   must equal the stream of an ``H264Encoder`` driven directly on the
   same frames with the job's gop and each frame's qp from
   ``RateController("cq", qp=26)``; (d) the jobs' wall time and fps, the
   crop/scale filter's time per frame on the card, the resample kernel's
   time on (a)'s three planes (one launch: back to back, and with a cold
   L2 after a 64 MB write) beside the function's bound (its banded taps
   and its planes), its own device time (``torch.profiler``), registers,
   local bytes and shared memory, its plain version's time, the time of
   the two dense ``torch.matmul`` products that compute the same function
   (the library call, used nowhere in the port) and its launches per job
   frame, and the time to bring the scaled planes back to the host, and
   the kernel's time on a DVD frame to 1080p (both upscales, warm); (e)
   the
   kernel on a letterbox P frame's own inputs (the source's next frame,
   scaled on the card, analysed against (a)'s final references), as in
   step 4.
6. The device filter suite (``handbrake_tpu_torch/filters``): (a) every
   filter of ``tools/profile_filters.suite()`` at its CLI flag's settings
   on a window of ``make_interlaced_clip`` 1920x1080 frames (colorspace:
   a 3840x2160 10-bit BT.2020 PQ frame to BT.709, hable), on the card and
   on the CPU: the integer filters equal, the float ones within 1 LSB,
   the share of samples that differ printed; (b) the hqdn3d kernel
   (``csrc/hqdn3d.cu``) against its plain version on the card over 3
   consecutive 1080p frames and a 3840x2160 10-bit frame pair, the f32
   state carried: outputs and states equal (max_abs_err 0, state
   difference 0); its division by 255 against ``__fdiv_rn`` over every
   f32 in [0, 256) (0 mismatches); and its chain probe, one warp through
   dependent low-pass steps with the kernel's division and with
   ``__fdiv_rn``, cycles and time a step; (c) a 33-frame 1920x1080 woven
   y4m (header flag ``It``) through ``cli.__main__.main`` with
   ``--comb-detect --decomb --hqdn3d -e h264 -q 28 --encoder-profile
   high`` and the default preset: 33 samples at 1920x1080, deblock264
   launched once per analysed P frame and hqdn3d once per frame, the
   first 3 samples equal to the port's CPU encoder's on the planes the
   job encoded; (d) the warm ms per 1080p frame of each filter on the
   card (CUDA events, planes already there) beside its bytes bound, the
   job's fps, and the kernel's time beside its bound and the chain floor
   that (b)'s probe measured (luma's 2,998 steps at the probe's cycles a
   step and the top SM clock), and as a multiple of it.
7. The H.264-source job at 1080p: (a) 33 ``make_clip`` 1920x1080
   frames encoded on the card by the port's encoder (High profile,
   serial), its reconstruction kept after each frame; the port's decoder
   must give back all 33, and the decoder's host ms per frame is printed;
   (b) that stream in an mp4 (the port's ``MP4Writer``) through
   ``cli.__main__.main(["-i", src, "-o", out.mkv, "-e", "h264", "-q",
   "28", "--encoder-profile", "high"])``, default preset and device: the
   scan decodes its previews, deblock264 launches once per analysed P
   frame, and the mkv (read back with the port's ``MKVDemuxer`` and
   decoded) holds 33 frames at 1920x1080; (c) the same job with ``-f
   mp4`` gives the same H.264 samples; (d) the mkv as a source: it
   scans and transcodes again to mp4 (33 samples); the jobs' fps.
8. Audio jobs on the card (the audio is host code, as in the JAX
   package; the video path runs the deblock kernel): (a) step 7's stream
   in an mp4 with three sound tracks as long as it, written by the
   port's encoders and ``MP4Writer``: AAC stereo 48 kHz, AC-3 5.1 48 kHz
   and PCM s16le stereo 44.1 kHz; (b) the CLI's default preset
   (``-e h264 -q 28 --encoder-profile high``: AAC stereo 160 kb/s from
   track 1) to mp4: the AAC track decodes through the port's decoder to
   within one AAC frame of the source track's samples, starts at the
   video's first pts, and its packets equal those of the port's
   ``AudioChain`` run on the host on the same source packets; its video
   samples equal those of the same job with ``-a none``; deblock264 once
   per analysed P frame; (c) ``-a 1,2,3 -E copy:aac,flac,ac3 -R
   auto,auto,48`` to mkv: track 1's packets equal the source's, track 2
   (5.1 AC-3 to stereo FLAC) decodes through the port's FLAC decoder to
   exactly the host's AC-3 decode, stereo mixdown and 16-bit
   quantization, track 3 (44.1 kHz PCM resampled to 48 kHz, AC-3) has
   the expected frame count; (d) the jobs' fps with and without audio,
   the audio decoder's and chain's host time in (b), and the AAC, AC-3
   and FLAC encoders' host seconds per second of 48 kHz stereo audio
   (AAC also with its MDCT matrix rebuilt on every call, as the JAX
   package does, which must give the same bytes).
9. Subtitles (``filters/rendersub.py``'s blend is torch operations, not
   a kernel): (a) ``blend_rgba`` on the card against the CPU, byte for
   byte, on 1920x1080 and 3840x2160 frames, 8 and 10 bits, 4:2:0, 4:2:2
   and 4:4:4, with four patches: a two-line cue from the machine's
   rasterizer (its name printed), a 1600x240 PGS card decoded by the
   port's ``PgsDecoder``, a 1400x200 random-alpha patch at an odd
   offset, and one clamped at the right and bottom edges; each patch's
   warm ms a call (CUDA events) and launches a call (``torch.profiler``)
   on a 1080p 8-bit 4:2:0 frame, beside its bytes bound at the card's
   own memory rate; (b) step 7's stream in an mkv with an S_HDMV/PGS
   track (a card shown at frame 5, cleared at frame 25) and an
   S_TEXT/UTF8 track, through the CLI's default preset with ``-s 1,2
   --subtitle-burned 1`` to mp4: its first 6 samples equal the CPU run's
   (``--device cpu``, the source's first 6 frames), the tx3g samples
   equal the cues (gaps filled), the decoded frames show the card's
   colour in its rectangle for 20 frames from frame 5 or 6 and not
   before; the fps with and without ``-s`` and render_sub's share of the
   filter graph's host time; (c) job (a)'s letterboxed source with
   ``--srt-file`` and ``--srt-burn 1``: its first 3 samples equal the
   CPU run's, and the burned text's box in the decoded 1920x804 output
   is horizontally centred and in the bottom fifth.
10. B-frames on the job path (the walker, ``codecs/h264/encoder_b.py``,
   is host code, as in the JAX package; the job's crop/scale runs the
   resample kernel on the card): (a) job 5 (a)'s letterboxed source, its
   first 5 frames, through ``cli.__main__.main(["-i", src, "-o", out.mp4,
   "-e", "h264", "-q", "28", "--bframes", "3"])``, default preset and
   device, under ``torch.profiler``: 5 samples at 1920x804, an IDR and
   a group of a P and three B frames, the decode order not the
   display order and non-zero ctts offsets, the resample kernel launched
   once a frame, and one log line that the profile's CABAC and 8x8
   transform are not applied; (b) the mp4's stream decoded by the port's
   ``NativeH264Decoder`` equals the walker's reconstructions (kept by a
   spy on the job's adapter), frame for frame in display order, and the
   planes the encoder received equal the port's ``CropScaleFilter`` on
   the CPU for the same source frames; (c) five random-noise 320x192
   frames, on which the JAX package's walker raises (its motion
   compensation reads outside its padded reference), through
   ``H264BEncoder(bframes=3)``: they encode and decode to its
   reconstructions; (d) the job's wall time and fps, the walker's host
   ms per I, P and B frame, the stream's bytes beside those of the same
   job without ``--bframes``, and the card's busy share over the job.
11. Scale-out paths on the card, one JSON line a part with the card's
   name and power limit: (a) phase 7's stream decoded by 4 threads at
   once, every decode equal to the serial one (the count that differ
   printed, 0 or the run fails), and two ``work.do_job`` calls on
   threads over phase 7's mp4 and mkv (their first 12 frames) equal to
   the same jobs run one after the other; (b) a 1080p y4m of 33 frames
   through ``work.do_job`` (H.264 High, ``keyint=8``) with
   ``checkpoint``, its journal kept as a kill leaves it, cut after its
   second GOP marker, the output deleted and the job resumed: the file
   equal to the uninterrupted one, the two runs' times, deblock264's
   launches in the resumed run (at least its P frames after the resume
   point); (c) job (a)'s letterboxed source through the CLI's default
   preset with ``--gop-parallel 4``: each GOP's stream equal to its
   chunk encoded serially on the card by its own encoder, the mp4's
   samples equal to the GOPs' access units, the resample kernel
   launched once a frame, the first 8 encoded frames
   cut to 2 GOPs equal between the card and the CPU, then ``-b 2000
   --two-pass`` (the target and achieved kb/s), and fps and the card's
   busy share (``torch.profiler``) beside the same job without
   ``--gop-parallel``; (d) nlmeans with ``tile_parallel`` 2 and 4 (taken,
   and run untiled on one card) on two 1080p 4:2:0 frames on the card,
   equal to the filter without it bit for bit, and each one's ms a
   frame, timed in turns; (e) two
   ``WorkerServer``s on the card in this process and a ``Controller``
   over them: phase 7's stream with a PCM track, to mkv with AAC; 33
   video packets and the AAC track, and each worker's segment equal to a
   ``do_job`` of its range on the card.
12. Disc and stream sources on the card, each source built in a
   temporary directory by ``tools/source_builders.py`` from the committed
   fixtures (``tests/data/torch_sources``) and the port's encoders, one
   JSON line a part with the card's name and power limit: (a) a
   ``VIDEO_TS`` folder, the 720x480 MPEG-2 fixture (24 pictures, IBBP)
   over two VOBs with an AC-3 2.0 and a 16-bit DVD LPCM track, a white
   VobSub card on stream 0x20 and IFOs with a palette and two chapters,
   through ``cli.__main__.main`` on the default preset and device with
   ``--decomb -m -a 1,2 -E copy:ac3,aac -s 1 --subtitle-burned 1
   --previews 2``: 24 samples, the card's rectangle brighter from its
   frame on and, on the last frame (which decomb holds until the
   flush), within the other card frames' range, two chapters, the AC-3 samples equal to the VOBs' frames,
   the first 3 samples equal to the job the CLI built run on the CPU
   over the folder's first 4 pictures, deblock264 launched at least once
   for every P frame, the resample kernel once a frame if the preset
   scales and never if not (which holds is printed); (b) a ``BDMV``
   folder over two m2ts clips and an MPLS with two chapter marks: phase
   7's 1080p stream, an AC-3 5.1 track (stream type 0x81), the
   committed TrueHD fixture's access units with AC-3 5.1 syncframes as
   its core on one PID (0x83, PES extensions 0x72 and 0x76), the
   committed E-AC-3 access units (0x84), DTS-HD whose extension
   substream says 8 channels (0x85) and a PGS card (0x90), through the
   CLI to mkv with ``-a 1,2,3,4,5 -E
   copy:ac3,copy:truehd,copy:ac3,copy:eac3,copy:dts -s 1
   --subtitle-burned 1 --previews 2``: the title's track list (printed,
   the core a track of its own), 33 frames, two chapters, each copy's
   blocks equal to its stream's frames (the TrueHD blocks the fixture's
   units, the first with a major sync), each copy labelled with its
   stream's rate and channels, the card brighter in its rectangle once
   burned, the first 3 samples equal to the job the CLI built run on
   the CPU over the folder's first 3 pictures, no resample launch,
   deblock264 once per analysed P frame; (c)
   phase 7's stream with the MP2 fixture in a 188-byte TS with a corrupt
   sync byte (a null packet) mid-file, through ``work.do_job`` to mp4
   with AAC: 33 samples, the first 3 equal to the CPU's run of the first
   3 frames; (d) the committed MJPEG AVI (6 frames, 640x480) through
   ``work.do_job``: 6 samples, and the planes its encoder was given
   equal the port's MJPEG decoder run on the host; (e) each job's fps
   and the card's busy share (``torch.profiler`` tracing the card, its
   device events summed from the raw trace and held equal to
   ``key_averages`` on (d)), the MPEG-2 decoder's host ms a 720x480 frame
   (the fixture's first 8 pictures) and the MJPEG decoder's a 640x480
   frame, beside deblock264's step 4 time.
13. HEVC and AV1 at 1080p on the card, one JSON line for the phase with
   the card's name and power limit: (a) the HEVC CTU analyzer
   (``codecs/hevc/analyzer.py``, torch ops) on two ``make_clip`` frames
   padded to 1920x1088, Main and (the planes x 4) Main 10, and the AV1
   motion search (``codecs/av1/analyzer.py``, search range 8) on the
   same planes, each on the card and on the CPU (mv and sad equal), timed
   (CUDA events, median of 20 calls), beside its bytes and
   integer-operation bounds, and one call's device ms and kernels traced
   by ``tools/profile_analyzers.py`` in a fresh process; (b) a 2-frame
   1080p y4m (an IDR and a P) through ``cli.__main__.main(["-i", src,
   "-o", out.mkv, "-Z", "H.265 MKV 1080p30"])`` under ``torch.profiler``,
   in a card process of its own: 2 samples of 1920x1080 with an hvcC,
   both equal to the same CLI job on the CPU (``--device cpu``, in a
   process of its own), the analyzer
   called once a P frame, each access unit decoded as it comes by the
   port's HEVC decoder (a child process) to the encoder's
   reconstruction, the mkv's samples those access units; fps, the card's
   busy share, the walker's host seconds an I and a P frame, the
   decoder's host ms a frame; (c) the same with ``-Z "AV1 MKV 1080p30"``
   (av1C in the CodecPrivate), beside (b); (d) (b)'s mkv through the CLI
   to H.264 High mp4 (``--previews 1``): 2 samples, the planes the H.264
   encoder was given equal to the HEVC encoder's reconstructions; and a
   2-frame 10-bit y4m with ``-e x265 --encoder-profile main10``: a 10-bit
   encoder, the mkv decoded (in a process of its own) to 16-bit frames
   equal to its reconstructions.
14. Several ranks of one job (``parallel/mesh.py``), one JSON line with
   the card's name and power limit: (a) step 11 (c)'s letterboxed
   source with ``--gop-parallel 4`` through ``cli.__main__.main`` on 2
   ranks of this card under ``python -m torch.distributed.run
   --standalone --nproc-per-node 2`` (each rank this script with
   ``--mesh-rank cli DIR ARGV``: the CLI under torch.profiler), over
   gloo, and the same job in one fresh process (``--nproc-per-node 1``,
   no process group) beside it: each mp4 equal to 11 (c)'s one-rank
   file byte for byte; fps,
   each rank's device ms and busy share over the job, the resample
   launches on each rank (33 on rank 0, none elsewhere), each rank's
   wire counters; (b) the same to ``-b 2000 --two-pass`` through
   ``-m handbrake_tpu_torch.cli`` itself, equal to 11 (c)'s two-pass
   file; (c) nlmeans with ``tile_parallel`` 2 on a 1080p 4:2:0 frame over
   the two ranks (``--mesh-rank tiles``) equal to the untiled filter bit
   for bit, each timed in turns; (d) where the run started with two or
   more cards, (a) and (c) over NCCL on min(4, cards) of them in a
   torchrun of their own, else a line that says why no NCCL world ran.
15. The libavcodec catalog (``codecs/avcodec.py``, ctypes on the system
   library), one JSON line with the card's name and power limit: (a) the
   libav*, libvpx, libopus, libmp3lame, libvorbis and libtheora sonames
   that ``ldconfig -p`` lists, and the binding's ``missing()`` reason;
   (b) where the library is missing, each catalog job must refuse, named,
   before its pipeline starts (no frame read or decoded) and before its
   output file exists, each timed: ``-Z "WebM 1080p30"`` on 11 (c)'s
   letterboxed y4m and ``-a 1 -E opus`` on 8's source through
   ``cli.__main__.main`` (exit code non-zero, the message on stderr),
   and the committed catalog sources (``tests/data/torch_sources/``: a
   VP9 webm, an MPEG-4 AVI with B-frames, an mkv with an E-AC-3 track,
   a libx265 mkv beyond the native HEVC subset) to H.264 through
   ``work.do_job`` (the stated exception); a job that runs fails the
   phase; (c) where the library is present, the WebM 1080p30 job on 9
   frames of that y4m (resample launches, fps, libvpx host ms a frame,
   the card's busy share; the webm decodes to 9 frames) and the MPEG-4
   AVI to H.264 (deblock264 launches; the mp4 decodes to 12 frames).
16. Refusals ahead of the work, one JSON line with the card's name and
   power limit: (a) 13's 2-frame 1080p y4m through ``cli.__main__.main``
   with ``--bframes 3 -x cabac=1`` must exit non-zero naming
   ``cabac=1`` (the B-frame walker codes CAVLC with no in-loop filter
   and no 8x8 transform), start no pipeline and leave no file; (b) step
   10's log line, printed; (c) with libavcodec missing (hidden from the
   binding where it is there), ``-Z "WebM 1080p30"`` on 11 (c)'s y4m and
   ``-a 1 -E opus`` on 8's source through the CLI must refuse naming the
   sonames, with no scan started, no pipeline and no file, each in under
   0.5 s of wall time, printed.
17. Anamorphic jobs through ``cli.__main__.main`` on the card, each
   beside the same CLI job on the CPU (``--device cpu``, a process of
   its own started first), one JSON line a part with the card's name
   and power limit: (a) a ``VIDEO_TS`` folder over the committed 16:9
   PAL MPEG-2 fixture (its first PAL_N = 8 of 25 pictures of 720x576,
   aspect_ratio_information
   3, frame_rate_code 3; IFO attributes PAL 16:9) through the default
   preset with ``--encoder-profile high`` to mp4: the title's pixel
   aspect 64:45 and rate 25/1, the SPS's VUI aspect and the ``pasp``
   64:45, the VUI timing and every sample's duration 25 fps, one sample
   a picture, the file equal to the CPU's, deblock264's launches
   printed; (b) 4 frames of 1440x1080 coded on the card by the port's
   encoder with VUI aspect 4:3 (annex-B) through ``--loose-anamorphic
   --maxWidth 960 -f mkv``: the resample kernel once a frame, the
   DisplayWidth/DisplayHeight 16:9 to a pixel, the SPS's aspect the
   job's, the file equal to the CPU's; (c) 2 frames of a 720x480 y4m
   with ``A32:27`` through ``-e x265 -f mkv``: the HEVC VUI's aspect
   32:27, the display size 853x480, the file equal to the CPU's.
18. A DVD's sound through a preset and the CLI on the card, one JSON
   line a part with the card's name and power limit: a VIDEO_TS folder
   of 5 pictures of the 720x480 MPEG-2 fixture with an AC-3 3/2+LFE
   track at 448 kb/s from the port's encoder (substream 0x80), a DTS 5.1
   track of core frames that decode to nothing, each of its own bytes
   (0x89), both laid into 2048-byte
   sectors as an authoring tool lays them (frames across PES packets, a
   PTS where a frame begins), and a DVD LPCM stereo track (0xA2), the
   IFO's audio attributes eng, eng, fre; (a) a preset
   imported with ``--preset-import-file`` (AudioLanguageList ["eng"],
   "first", AudioList [AAC stereo 160, copy], AudioCopyMask
   ["copy:ac3"], fallback AAC, H.264 High) to mp4: two audio tracks,
   both of track 1, the copy's frames and ``dac3`` the stream's, each
   mp4 sample of the copy one syncframe of 1536 samples, the track 6
   channels at 48 kHz, the AAC track decoding to the AC-3 track's
   length, the file equal to the
   same CLI job on the CPU (a process of its own, started first),
   deblock264's launches printed; (b) ``-a 1,2,3 -E
   copy:ac3,copy:dts,copy:ac3`` to mkv: the AC-3 and DTS copies equal to
   the VOBs' (``A_DTS``), both 6 channels at 48 kHz, each DTS block one
   whole core frame, the LPCM track encoded to AC-3 with the log
   line that says so; (c) ``-a 2 -E copy`` with the default preset (mask
   AAC and AC-3): DTS falls back to AAC, whose DTS decoder needs
   libavcodec, absent there (hidden where it is there), so the CLI
   fails with the stated ``WorkError`` and leaves no file; (d) the DVD
   job (H.264 High to mp4, keyint 2) with AAC beside the AC-3 copy of
   track 1, and again with no sound, each checkpointed, its journal cut
   after the first GOP and resumed: both runs' seconds and the frames
   each decoded (the 5 pictures hold one I picture, the first, so the
   resume decodes from it, with sound or without), the resumed file
   equal to the uninterrupted one.
19. Resumes on the card, one JSON line a part with the card's name and
   power limit, each with both runs' seconds, the frames each decoded
   and coded, the kernels' launches in each, the resume path and its
   log line: (a) 12 frames of a 1080p y4m through hqdn3d and CFR at
   half rate, keyint 2, the journal cut after the second GOP: the rate
   shaper changes the frame count and hqdn3d keeps state, so the resume
   decodes all 12 frames and filters them (hqdn3d launched once for
   each frame the shaper gives, as in the full run) and drops the
   frames done after the filters, deblock264 launched once for each P frame coded after the
   boundary; (b) job 7's clip coded on the card with an IDR each 4
   frames (12 frames, mp4), scaled to 1280x720, cut after GOP 2: the
   decode starts at the IDR of the boundary (8 packets skipped, 4
   frames decoded, resample launched 4 times); (c) 12 (a)'s DVD at 16
   pictures (a closed GOP of 10, an open GOP whose I picture has two
   leading B pictures) with its AC-3 copied, its LPCM to AAC and the
   card burned, scaled to 1280x720, keyint 7, cut after GOP 2: the
   decode starts at the open GOP's I picture, the leading B pictures
   dropped; each resumed file equal to the uninterrupted one.
22. A stream's own frame rate and a copied track's true label, one JSON
   line a part with the card's name and power limit: (a) three 1080p
   frames coded on the card at 24000/1001 as an annex-B .264 and at 25
   fps in a TS, each through the CLI's default preset: the title, the
   coded VUI and the mp4 durations carry the stream's rate, the log
   line names it, deblock264 launched for each P frame, and each file
   equals the same CLI job's on the CPU (a process of its own, started
   first); (b) that TS's video with a DTS-HD Master Audio track (48 kHz
   core, 96 kHz lossless asset) and an ADTS 5.1 track opened by a
   program config element, copied to mkv: labelled 96000 Hz 8 channels
   and 48000 Hz 6 channels, the AAC config carrying the element, each
   block the stream's frame (the first AAC block less the element);
   (c) the committed MJPEG AVI's first six frames with an MP2 track
   through the default preset: the MP2 decoded to AAC (finite, its
   length the MP2's), the file equal to the CPU run's.
23. HandBrake's peak-rate shaping, one JSON line with the card's name and
   power limit: R23_N 1280x720 frames coded on the card at 60 fps in an
   mp4 with a 48 kHz stereo AAC track as long, through the CLI's
   default preset (peak 30): 6 video samples of 3000 ticks, the video as
   long as the source's and within a peak frame time of the sound (less
   its two AAC encoders' latency), the coded VUI and the encoder at 30,
   the ``pfr:`` log line, deblock264 launched for each kept P frame, and
   the file equal to the same CLI job's on the CPU (a process of its
   own, started first).
20. Print the kernels line (deblock264: ``ms`` is step 4's time, beside
   the bytes bound and the dependency-chain floor; ``job_launches`` are
   step 5's, 7's and 8's counts, ``ms_letterbox_input`` step 5 (e)'s
   time; hqdn3d: ``ms`` is 6 (b)'s time at 1080p, ``launches`` 6 (c)'s
   count, with ``launches_per_frame``; resample: ``ms`` and ``cold_ms``
   are 5 (d)'s kernel times on (a)'s planes, ``ms_dvd`` its times on the
   DVD frames beside ``bound_dvd_ms``, ``launches`` 5 (a)'s count, one a
   frame, ``library_ms`` the dense products' time, ``regs``,
   ``local_bytes`` and ``smem_bytes`` the kernel's, ``job_launches``
   its counts in jobs 5 (a), 9 (c), 10 (a), 11 (c) and on 14 (a)'s rank
   0; deblock264's
   ``job_launches`` include 11 (b)'s resumed job, the four jobs of step
   12, 17 (a)-(b), 18 (a)-(b) and 19 (a)-(c)'s resumes; resample's
   those of 12 (a)-(b), 17 (a)-(b), 18 (a)-(b) and 19 (b)-(c)'s
   resumes, and 22's four jobs, 23's job; hqdn3d's 19 (a)'s resume),
   steps 7's to 23's numbers, the card's name and power limit, and the
   result line.

Step 14's ranks run this script with ``--mesh-rank KIND DIR ARGV...``
(above).  Step 13's helper processes run it with: ``--decode-check
CODEC MKV NPZ`` decodes an mkv's video with the port's decoder and
prints one JSON line (frames, equal to the reconstructions in NPZ, host
ms a frame); ``--walker-job CODEC SRC DIR`` runs (b)'s or (c)'s job on
the card and prints its numbers and its decode's as one JSON line.
``--mesh-only`` runs step 1's build, step 11 (c) (which makes the
one-rank files) and step 14 alone, on every card the run can see, and
prints no result line: the check of 14 (d)'s NCCL world on a machine
with several cards.  ``--anamorphic-only`` runs step 1's build and step
17 alone and prints no result line; ``--audio-copy-only`` the build and
step 18; ``--resumes-only`` the build and step 19; ``--discs-only`` the
build and step 12, on step 7's stream encoded anew on the card;
``--rates-only`` the build and step 22; ``--pfr-only`` the build and
step 23.

Imports nothing of JAX and nothing of ``handbrake_tpu``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

W, H = 1920, 1080
N_FRAMES = 33           # IDR + 32 P frames: four full dispatch batches
NB = 8                  # dispatch batch of the main path (bench.py's)
QP = 26
N_CPU = 3               # frames also encoded on the CPU
MEM_BW = 3.35e12        # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
# the table's nearest rate for the kernel's scalar int32 work: H100 SXM
# non-tensor f32, ops/s (NVIDIA data sheet)
SCALAR_RATE = 67e12
# int32 operations per filtered line, estimated from the edge filters of
# csrc/deblock264.cu (loads and stores not counted)
OPS_PER_LINE = {"luma": 40, "chroma": 20}
# side data the function needs per MB: coded flags of the 16 4x4 blocks
# (2 B), mv (2 x int16), t8 and intra (1 B)
SIDE_BYTES = 7
# dependency chain of one MB step: dependent integer operations on the
# critical path of one luma edge filter (csrc/deblock264.cu luma_edge:
# difference, shift, adds, shift, clip, add, clip), and the latency of
# each in SM cycles (integer ALU latency on the card's generation)
CHAIN_OPS_PER_EDGE = 10
CYCLES_PER_OP = 4
KERNEL_REPS = 25
# (mb_w, mb_h, qp, with_strong variants): 1080p, tiny, tall, wide, the
# letterbox job's 1920x816, 2160p and 4320p (the largest frame the kernel
# takes; its plain version is slow, so one variant)
KERNEL_CASES = ((120, 68, 30, (False, True)), (1, 1, 36, (False, True)),
                (3, 7, 40, (False, True)), (8, 2, 24, (False, True)),
                (1, 68, 32, (False, True)), (120, 1, 26, (False, True)),
                (120, 51, 28, (False, True)),
                (240, 135, 28, (False, True)), (512, 270, 28, (False,)))
BIG = (4800, 9600)      # a luma plane above the kernel's size limit
# the job path (tools/profile_job.py defines its two jobs): a 2160p
# source holding 2.39:1 film between black bars of 276 rows, which the
# CLI's default preset brings down to 1920x804
JOB_OUT = (1920, 804)
CS_REPS = 9             # crop/scale calls timed on the card
# the filter phase: nlmeans and bm3d are compared with the CPU on two
# frames of the window (their CPU versions are the slow part), the rest
# on all three
SLOW_ON_CPU = ("nlmeans", "bm3d")
HQ_FRAMES = 3           # 1080p frames of the hqdn3d kernel's check
HQ_UHD = (3840, 2160)   # and a 10-bit frame pair at 2160p
HQ_PROBE_STEPS = 1 << 16   # dependent steps of the chain probe
# the f32 operations of one low-pass (pow counted as 4), three a sample
HQ_OPS_PER_SAMPLE = 3 * 12
# the resample kernel's cases against its plain version (5 (b)): (label,
# in_h, in_w, out_h, out_w, horizontal chroma siting shift); (a)'s planes
# are added from the job's own settings.  The narrow upscales are planes
# under 64 wide with many output rows, whose vertical order takes four,
# two and four lanes; "few rows 720" is a vertical product of 50 rows in
# tiles of 128 columns and a last one of 80; the narrow last tile (one
# column, two rows) rounds every product; the one-row products are a
# matrix-vector kernel's order (eight lanes, halves in the last columns,
# an fma tail)
RS_CASES = (("odd down", 999, 1777, 541, 1103, -0.25),
            ("odd up", 37, 53, 91, 129, 0.0),
            ("1080p to 720p", 1080, 1920, 720, 1280, 0.0),
            ("one row", 1, 97, 1, 50, 0.0), ("one sample", 1, 1, 3, 2, 0.0),
            ("NTSC DVD to 1080p", 480, 720, 1080, 1440, 0.0),
            ("NTSC DVD chroma", 240, 360, 540, 720, -0.25),
            ("PAL DVD to 1080p", 576, 720, 1080, 1920, 0.0),
            ("PAL DVD chroma", 288, 360, 540, 960, -0.25),
            ("narrow up 20", 15, 20, 120, 160, -0.25),
            ("narrow up 30", 23, 30, 240, 160, -0.25),
            ("narrow up 40", 30, 40, 240, 320, -0.25),
            ("few rows 720", 480, 720, 50, 360, 0.0),
            ("few rows, narrow last tile", 600, 129, 2, 60, 0.0),
            ("one row, tail of 5", 3, 101, 1, 127, 0.0))
# the DVD upscales (4:2:0 frames) whose kernel time 5 (d) also prints: a
# plane width that is not a multiple of 64, four lanes in the vertical
# order: (label, in_h, in_w, out_h, out_w)
RS_DVD = (("ntsc_720x480_to_1440x1080", 480, 720, 1080, 1440),
          ("pal_720x576_to_1920x1080", 576, 720, 1080, 1920))
RS_KINDS = ("lanczos", "bicubic", "bilinear", "point")
# the new kernel's ragged tiles (its first tile is 16 rows x 128 columns),
# each in one kind (label, in_h, in_w, out_h, out_w, shift, kind, input
# bits, maxval): a tile multiple and one more, one less; odd pitches;
# 16-bit output from 8-bit input; 8x down lanczos (48 taps, smaller tiles)
RS_RAGGED = (("tile+1", 66, 516, 17, 129, 0.0, "lanczos", 8, 255),
             ("tile-1", 62, 508, 15, 127, -0.25, "lanczos", 8, 255),
             ("2 tiles+1", 70, 520, 33, 257, 0.0, "bicubic", 8, 255),
             ("2 tiles-1", 60, 1016, 31, 255, -0.25, "lanczos", 10, 1023),
             ("odd pitch", 101, 333, 50, 166, 0.0, "lanczos", 8, 255),
             ("odd pitch 16-bit", 77, 1001, 38, 500, -0.25, "lanczos", 10,
              1023),
             ("16-bit out", 64, 512, 32, 256, 0.0, "bicubic", 8, 1023),
             ("8x down", 2160, 3840, 270, 480, 0.0, "lanczos", 8, 255),
             ("8x down 16-bit", 1080, 1920, 135, 240, -0.25, "lanczos", 10,
              1023))
SRC_N = 33              # frames of the H.264-source job (step 7)
FRAME_TICKS = 3003      # 90 kHz ticks of a frame at 30000/1001
AC3_SRC_BPS = 384000    # the audio source's 5.1 AC-3 track (step 8)
SPEED_SECONDS = 1.0     # audio each encoder's speed is measured on
# step 9: the blend's timing reps; the subtitle job's PGS card (Y, Cr, Cb
# of its palette entry, its rectangle x, y, w, h), shown at frame SUB_SHOW
# and cleared at SUB_CLEAR; its text cues (first frame, frames, text); the
# frames of its CPU run; how far (8-bit levels) the decoded rectangle's
# mean may be from the card's colour; the two-line cue of 9 (a) and (c)
BLEND_REPS = 25
SUB_CARD_YCRCB = (180, 200, 70)
SUB_RECT = (760, 860, 400, 120)
SUB_SHOW, SUB_CLEAR = 5, 25
SUB_TEXT_CUES = ((3, 6, "First soft cue"), (12, 5, "Second soft cue"))
SUB_CPU_FRAMES = 6
SUB_CARD_TOL = 8.0
SUB_CUE = "A burned subtitle\nin two lines"
# step 10: the B-frame job takes the letterbox source's first B_N frames
# with --bframes B_FRAMES (x264-medium's bframes=3/ref=3): an IDR, then
# a group of a P and three B frames (two groups until the smoke went over
# 950 s on a slow host; the checks are the same); the MC repair's noise
# frames
# (tests/test_torch_bframes.py's generator and one of its cases: the JAX
# package's walker raises on them)
B_N, B_FRAMES, B_Q = 5, 3, 28
B_GROUPS = (B_N - 1) // (B_FRAMES + 1)
# what the port logs at a B-frame job's start (its profile's CABAC and
# 8x8 transform are not applied)
B_LOG = "CABAC and 8x8 transform are not applied"
NOISE_W, NOISE_H, NOISE_N, NOISE_SEED = 320, 192, 5, 0
# step 11: decoder threads and two jobs on threads (their first frames);
# the resumed job's keyint and the GOP marker its journal is cut after;
# --gop-parallel, the cut held against the CPU, the two-pass target;
# nlmeans tiles and the timing repetitions
DEC_THREADS, THREAD_JOB_N = 4, 12
RESUME_KEYINT, RESUME_CUT = 8, 2
GP_N, GP_CPU_FRAMES, GP_CPU_GOPS, GP_KBPS = 4, 8, 2, 2000
TILES, NL_REPS = (2, 4), 3
# step 12: the disc sources' first pts, the DVD's VobSub card (x, y, w,
# h in the 720x480 picture) and the display frame it shows from, the
# disc scans' previews (each a decode on the host), the pictures the
# MPEG-2 decoder is timed on; the committed AVI's frames
DVD_T0 = 4 * FRAME_TICKS
DVD_CARD, DVD_CARD_AT = (300, 200, 64, 32), 6
DVD_PREVIEWS, DVD_TIMED = 2, 8
MJPEG_N = 6
# the Blu-ray's PGS card (x, y, w, h in the 1920x1080 picture) and the
# pictures it shows at and is cleared at (burned a picture late: ROADMAP
# 3.19), so the first N_CPU samples held against the CPU hold the burn
BD_CARD, BD_CARD_AT, BD_CARD_OFF = (760, 860, 400, 120), 1, 20
# step 13: HEVC and AV1 at 1080p.  The analyzers' coded planes (1088
# rows: 34 CTUs of 32, 68 blocks of 16) and their timing reps; the jobs'
# frames (an IDR and a P: the smoke's time), the frames of their CPU
# runs and of the Main 10 job; the presets; the integer operations of a sample's SAD (a
# difference, its absolute value, an add)
HV_ROWS, AN_REPS = 1088, 20
HV_N, HV_CPU, HV_M10_N = 2, 2, 2
HV_PRESETS = {"hevc": "H.265 MKV 1080p30", "av1": "AV1 MKV 1080p30"}
SAD_OPS = 3
# step 14: the ranks of one job on this card (gloo), the cards of an
# NCCL world at most, a world's time limit; the cards this run could see
# when it started (before one_card)
MESH_RANKS, NCCL_MAX, MESH_LIMIT_S = 2, 4, 300
CARDS_AT_START = []
# step 15: the libraries whose sonames (a) lists; the committed catalog
# sources that (b) opens; (c)'s WebM frames
CATALOG_LIBS = ("libavcodec", "libavutil", "libavformat", "libswscale",
                "libswresample", "libvpx", "libopus", "libmp3lame",
                "libvorbis", "libtheora")
CATALOG_SOURCES = {"vp9": "vp9_176x144.webm",
                   "mpeg4_bframes": "mpeg4_bframes_176x144.avi",
                   "eac3": "eac3_176x144.mkv",
                   "x265": "x265_176x144.mkv"}
WEBM_N = 9
# step 16: the wall time a catalog refusal through the CLI may take (it
# comes before the scan)
REFUSE_LIMIT_S = 0.5
# step 17: (a) the 16:9 PAL DVD fixture's frame ticks at 25 fps and its
# pixel aspect; (b) the 1440x1080 H.264 source's frames, its VUI aspect
# and the loose job's max width; (c) the 720x480 y4m's frames and aspect;
# the scans' previews (each a decode from the start on the host); the
# OpenMP threads of (a)'s CPU run, the longest of the three; (a)'s
# pictures, cut from the fixture's 25 (its CPU run paces the phase)
PAL_TICKS, PAL_PAR = 3600, (64, 45)
PAL_N = 8
LOOSE_N, LOOSE_SAR, LOOSE_MAX_W = 4, (4, 3), 960
Y4M_PAR_N, Y4M_PAR = 2, (32, 27)
PAR_PREVIEWS, PAL_CPU_THREADS = 1, 5
# step 18: the DVD's pictures; its AC-3 5.1 track's rate; its DTS core
# frames (5.1, 48 kHz, 768 kb/s: 1024 bytes of 512 samples, 960 ticks);
# the IFO's audio attributes (codec, channels, ISO 639-1), one a stream;
# the preset job's audio list, mask and fallback; the CPU run's threads
COPY_DVD_N, COPY_AC3_BPS = 5, 448000
DTS_FRAME_BYTES, DTS_FRAME_TICKS = 1024, 960
COPY_DVD_ATTRS = [("ac3", 6, "en"), ("dts", 6, "en"), ("lpcm", 2, "fr")]
COPY_PRESET = {"PresetName": "DVD AAC and AC-3 copy", "VideoEncoder": "h264",
               "VideoProfile": "high", "VideoQualitySlider": 28,
               "FileFormat": "mp4", "AudioLanguageList": ["eng"],
               "AudioTrackSelectionBehavior": "first",
               "AudioCopyMask": ["copy:ac3"], "AudioEncoderFallback": "aac",
               "AudioList": [{"AudioEncoder": "aac", "AudioBitrate": 160,
                              "AudioMixdown": "stereo"},
                             {"AudioEncoder": "copy"}]}
COPY_CPU_THREADS = 4
# (d): the resumed DVD job's keyint and the frames its journal keeps
COPY_RESUME_KEYINT, COPY_RESUME_DONE = 2, 2
# step 19: resumes.  (a) the 1080p y4m's frames through hqdn3d and CFR
# at half rate, the job's keyint and the GOP marker its journal is cut
# after; (b) job 7's clip coded again with an IDR each R19_SRC_GOP
# frames (job 7's has one IDR), its frames, the job's keyint and cut,
# the frame-local chain's scale; (c) the DVD's pictures (12 (a)'s
# folder: AC-3, LPCM, the VobSub card), keyint and cut
R19_N, R19_KEYINT, R19_CUT = 12, 2, 2
R19_SRC_N, R19_SRC_GOP, R19_SCALE = 12, 4, (1280, 720)
R19_DVD_N, R19_DVD_KEYINT, R19_DVD_CUT = 16, 7, 2
# step 22: the 1080p frames of (a)'s streams (an IDR and two P frames:
# each is also coded by a CPU run), the sound frames of (b), the MJPEG
# frames of (c) and the OpenMP threads of each of the three CPU runs
R22_N, R22_SOUND_N, R22_MJPEG_N, R22_THREADS = 3, 12, 6, 2
# step 23: the 60 fps source's frames, size and frame ticks, the default
# preset's peak rate, the OpenMP threads of its CPU run; its sound's
# latency, in ticks, that no edit list marks: a frame of 1024 samples
# for each of the two AAC encoders it went through (the source's, the
# job's)
R23_N, R23_SIZE, R23_SRC_TICKS, R23_PEAK, R23_THREADS = 12, (1280, 720), \
    1500, 30, 4
R23_AAC_LATENCY = 2 * 1024 * 90000 // 48000


def smi(query):
    r = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def card() -> str:
    return smi("name,power.limit")


def max_clock_hz() -> float:
    return float(smi("clocks.max.sm").split()[0]) * 1e6


def deblock_case(seed, mb_w, mb_h, p_intra=0.2):
    """Random planes (half of the luma smooth, so filters fire) and MB
    data with intra MBs, as numpy, in the kernel's dtypes."""
    rng = np.random.default_rng(seed)
    Hp, Wp = mb_h * 16, mb_w * 16
    n_mb = mb_w * mb_h
    y = rng.integers(0, 256, (Hp, Wp)).astype(np.uint8)
    u = rng.integers(0, 256, (Hp // 2, Wp // 2)).astype(np.uint8)
    v = rng.integers(0, 256, (Hp // 2, Wp // 2)).astype(np.uint8)
    y[:Hp // 2] = (y[:Hp // 2] // 8) + 100
    u //= 2
    v //= 2
    mv = rng.integers(-20, 20, (n_mb, 2)).astype(np.int16)
    nnz = rng.integers(0, 3, (n_mb, 16)).astype(np.int32)
    nnz[rng.random((n_mb, 16)) < 0.6] = 0
    t8 = rng.random(n_mb) < 0.3
    intra = rng.random(n_mb) < p_intra
    nnz = np.where(intra[:, None], 0, nnz).astype(np.int32)
    return y, u, v, mv, nnz, intra, t8 & ~intra


def all_filtering_case(seed, mb_w, mb_h):
    """Flat planes in a checkerboard of 4x4 blocks two levels apart, and
    every bS >= 2 (every block coded, no 8x8 transform, some intra MBs):
    every edge of every MB filters, so the whole chain is driven."""
    rng = np.random.default_rng(seed)
    n_mb = mb_w * mb_h

    def steps(h, w, base):
        i, j = np.mgrid[0:h, 0:w]
        return (base + 2 * ((i // 4 + j // 4) % 2)).astype(np.uint8)

    return (steps(mb_h * 16, mb_w * 16, 100),
            steps(mb_h * 8, mb_w * 8, 120), steps(mb_h * 8, mb_w * 8, 130),
            rng.integers(-20, 20, (n_mb, 2)).astype(np.int16),
            rng.integers(1, 4, (n_mb, 16)).astype(np.int32),
            rng.random(n_mb) < 0.2, np.zeros(n_mb, bool))


def reset_counts():
    """Every kernel wrapper's launch count to 0, before a path is driven."""
    from handbrake_tpu_torch.codecs.h264 import deblock_cuda
    from handbrake_tpu_torch.filters import hqdn3d_cuda, resample_cuda
    deblock_cuda.launches = 0
    hqdn3d_cuda.launches = 0
    resample_cuda.launches = 0


def cuda_ms(fn, reps):
    """Median device time of fn() over reps runs, by CUDA events around
    each call (host-side preparation included)."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_ms(args, n=KERNEL_REPS):
    """The kernel alone: CUDA events around n back-to-back launches with
    the arguments prepared first (deblock_cuda.prepare), divided by n.
    These launches are not counted: they bypass the wrapper."""
    import torch
    from handbrake_tpu_torch.codecs.h264 import deblock_cuda
    lib = deblock_cuda.load()
    for _ in range(3):
        if lib.deblock264_launch(*args) != 0:
            raise RuntimeError("deblock264 launch failed")
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        lib.deblock264_launch(*args)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def bounds(planes, bs_v, bs_h, mb_w, mb_h, clock_hz):
    """The bound (bytes or operations, whichever is larger) and the
    dependency-chain floor of one launch on these inputs."""
    n_mb = mb_w * mb_h
    # each plane byte read once and written once, and the side data at
    # what the function needs (SIDE_BYTES per MB)
    nbytes = 2 * sum(p.numel() for p in planes) + SIDE_BYTES * n_mb
    # lines these inputs filter: 4 luma lines per bS group; chroma takes
    # luma edges 0 and 2, 2 lines per group, in U and V
    ops = (int((bs_v > 0).sum() + (bs_h > 0).sum()) * 4
           * OPS_PER_LINE["luma"]
           + int((bs_v[:, :, 0::2] > 0).sum()
                 + (bs_h[:, :, 0::2] > 0).sum()) * 2 * 2
           * OPS_PER_LINE["chroma"])
    t_bytes = nbytes / MEM_BW * 1e3
    t_ops = ops / SCALAR_RATE * 1e3
    # MB steps along the wavefront x 8 dependent edge filters x their
    # dependent integer operations x the latency of each
    sk = mb_w + 2 * (mb_h - 1)
    chain_us = sk * 8 * CHAIN_OPS_PER_EDGE * CYCLES_PER_OP / clock_hz * 1e6
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops, "t_bytes": t_bytes,
            "t_ops": t_ops, "chain_floor_us": chain_us}


def phase_build():
    from handbrake_tpu_torch.codecs.h264 import deblock_cuda
    from handbrake_tpu_torch.filters import hqdn3d_cuda, resample_cuda
    from handbrake_tpu_torch.native import (get_decoder_lib, get_lib,
                                            get_mjpeg_lib)

    def timed(f):
        t0 = time.perf_counter()
        f()
        return time.perf_counter() - t0

    builds = {"deblock264.cu (nvcc sm_90a)": deblock_cuda.load,
              "hqdn3d.cu (nvcc sm_90a)": hqdn3d_cuda.load,
              "hb264.cpp (g++)": get_lib, "hbdec264.cpp (g++)":
              get_decoder_lib, "hbdecmjpeg.cpp (g++)": get_mjpeg_lib}
    for ib, ob in resample_cuda.SAMPLE_BYTES:
        builds[f"resample.cu {8 * ib}->{8 * ob} bit (nvcc sm_90a, "
               f"--fmad=false)"] = functools.partial(resample_cuda.load,
                                                     ib, ob)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as ex:
        futures = {k: ex.submit(timed, f) for k, f in builds.items()}
        times = {k: f.result() for k, f in futures.items()}
    print("build: " + ", ".join(f"{k} {t:.1f} s" for k, t in times.items())
          + f", {time.perf_counter() - t0:.1f} s in all", flush=True)


def check_kernel(case, mb_w, mb_h, qp, strong, intra_none=False):
    """One launch against deblock_plain(compute_bs(...)) on the card;
    returns (max_abs_err, samples changed, kernel inputs, bS)."""
    import torch
    from handbrake_tpu_torch.codecs.h264.deblock import deblock_scal
    from handbrake_tpu_torch.codecs.h264.deblock_cuda import deblock_cuda
    from handbrake_tpu_torch.codecs.h264.deblock_torch import (compute_bs,
                                                               deblock_plain)
    dev = torch.device("cuda")
    y, u, v, mv, nnz, intra, t8 = (torch.from_numpy(a).to(dev) for a in case)
    if intra_none:
        intra = None
    scal = deblock_scal(qp, max(0, qp - 3))
    bs_v, bs_h = compute_bs(mb_w, mb_h, mv, nnz, intra, t8)
    got = deblock_cuda(y, u, v, mv, nnz, intra, t8, scal, strong)
    want = deblock_plain(y, u, v, bs_v, bs_h, scal, strong)
    torch.cuda.synchronize()
    err = max(int((a.int() - b.int()).abs().max()) for a, b in zip(got, want))
    changed = sum(int((a != b).sum()) for a, b in zip(got, (y, u, v)))
    print(f"deblock264 {mb_w}x{mb_h} MBs qp {qp} with_strong={strong}"
          f"{' mb_intra=None' if intra_none else ''}: max_abs_err {err}, "
          f"{changed} samples filtered", flush=True)
    if err != 0:
        raise RuntimeError("deblock264 disagrees with its plain version")
    if changed == 0 and mb_w * mb_h > 100:
        raise RuntimeError("deblock264 filtered nothing")
    return err, changed, (y, u, v, mv, nnz, intra, t8, scal), (bs_v, bs_h)


def phase_kernel(label, clock_hz):
    """Kernel vs plain version on random, all-filtering and large inputs;
    returns the kernel's JSON entry (without the main-path numbers)."""
    import torch
    from handbrake_tpu_torch.codecs.h264 import deblock_cuda
    from handbrake_tpu_torch.codecs.h264.deblock_torch import (compute_bs,
                                                               deblock_plain)
    max_err = 0
    for mb_w, mb_h, qp, variants in KERNEL_CASES:
        case = deblock_case(mb_w * 1000 + mb_h, mb_w, mb_h)
        for strong in variants:
            err, _, args, _ = check_kernel(case, mb_w, mb_h, qp, strong)
            max_err = max(max_err, err)
    err, _, args, (bs_v, bs_h) = check_kernel(
        deblock_case(120068, 120, 68), 120, 68, 30, False, intra_none=True)
    max_err = max(max_err, err)
    case = all_filtering_case(7, 120, 68)
    for strong in (False, True):
        err, changed, _, _ = check_kernel(case, 120, 68, 36, strong)
        max_err = max(max_err, err)
        if changed < sum(a.size for a in case[:3]) // 8:
            raise RuntimeError("the all-filtering input filtered too little")
    # the main path's variant and shape (all inter), random input
    y, u, v, mv, nnz, intra, t8, scal = args
    _, largs = deblock_cuda.prepare(*args, False)
    ms_random = kernel_ms(largs)
    wrapper_ms = cuda_ms(lambda: deblock_cuda.deblock_cuda(*args, False),
                         KERNEL_REPS)

    def plain():
        return deblock_plain(y, u, v, *compute_bs(120, 68, mv, nnz, intra,
                                                  t8), scal, False)

    plain_ms = cuda_ms(plain, 3)
    b = bounds((y, u, v), bs_v, bs_h, 120, 68, clock_hz)
    print(f"deblock264 at 1080p, random input ({label}): kernel "
          f"{ms_random:.4f} ms ({KERNEL_REPS} back-to-back launches, CUDA "
          f"events), wrapper call {wrapper_ms:.4f} ms (median of "
          f"{KERNEL_REPS} single calls, CUDA events), plain {plain_ms:.2f} "
          f"ms (compute_bs + deblock_plain); bound {b['bound_ms'] * 1e3:.2f} "
          f"us by {b['bound_by']} ({b['bytes']} B at 3.35 TB/s: "
          f"{b['t_bytes'] * 1e3:.2f} us; ~{b['ops']} int32 ops at 67 T/s: "
          f"{b['t_ops'] * 1e3:.2f} us); chain floor "
          f"{b['chain_floor_us']:.1f} us", flush=True)
    # above the size limit the wrapper raises, naming the limit
    dev = torch.device("cuda")
    n_mb = (BIG[0] // 16) * (BIG[1] // 16)
    big = (torch.zeros(BIG, dtype=torch.uint8, device=dev),
           torch.zeros((BIG[0] // 2, BIG[1] // 2), dtype=torch.uint8,
                       device=dev),
           torch.zeros((BIG[0] // 2, BIG[1] // 2), dtype=torch.uint8,
                       device=dev),
           torch.zeros((n_mb, 2), dtype=torch.int16, device=dev),
           torch.zeros((n_mb, 16), dtype=torch.int32, device=dev))
    try:
        deblock_cuda.deblock_cuda(*big, None, None, scal, False)
    except ValueError as e:
        print(f"deblock264 at {BIG[1]}x{BIG[0]}: refused ({e})", flush=True)
    else:
        raise RuntimeError("deblock_cuda took a frame above its limit")
    del big
    return {"name": "deblock264", "route": "cuda",
            "source": "handbrake_tpu_torch/csrc/deblock264.cu",
            "replaces": "handbrake_tpu/codecs/h264/deblock_pallas.py:213",
            "equal": max_err == 0, "max_abs_err": max_err,
            "ms_random": ms_random, "wrapper_ms": wrapper_ms,
            "plain_ms": plain_ms, "bound_ms": b["bound_ms"],
            "bound_us": b["bound_ms"] * 1e3, "bound_by": b["bound_by"],
            "chain_floor_us": b["chain_floor_us"], "library_ms": None}


def encode(frames, device, batch, depth):
    """Encode frames through begin_frame/finish_frame with up to `depth`
    frames in flight; returns (per-frame bytes, encoder, seconds in all,
    seconds in begin_frame, seconds in finish_frame)."""
    import torch
    from handbrake_tpu_torch.codecs.h264.encoder import (EncoderConfig,
                                                         H264Encoder)
    enc = H264Encoder(EncoderConfig(
        width=W, height=H, qp=QP, gop=600, deblock=True, cabac=True,
        transform8x8=True, dispatch_batch=batch), device=device)
    out, pend = [], []
    t_begin = t_finish = 0.0

    def finish():
        nonlocal t_finish
        t = time.perf_counter()
        out.append(enc.finish_frame(pend.pop(0)))
        t_finish += time.perf_counter() - t

    t0 = time.perf_counter()
    for f in frames:
        t = time.perf_counter()
        pend.append(enc.begin_frame(*f))
        t_begin += time.perf_counter() - t
        if len(pend) > depth:
            finish()
    while pend:
        finish()
    if device != "cpu":
        torch.cuda.synchronize()
    return out, enc, time.perf_counter() - t0, t_begin, t_finish


def phase_main_path(label):
    import torch
    from handbrake_tpu_torch.codecs.h264 import deblock_cuda
    from handbrake_tpu_torch.utils.synth import make_clip
    # one frame more than the drive: the source of the main-path-input
    # timing of the kernel (make_clip's first frames do not depend on n)
    frames = make_clip(W, H, N_FRAMES + 1)[:N_FRAMES]
    # warm-up: one batch through both drives, so that neither timed run
    # pays for first allocations and library set-up
    encode(frames[:NB + 1], "cuda", NB, NB + 2)
    encode(frames[:2], "cuda", 1, 0)
    # the main path: batches of 8, ~2 batches in flight (bench.py's drive)
    reset_counts()
    main, enc8, t_main, _, _ = encode(frames, "cuda", NB, NB + 2)
    launches = deblock_cuda.launches
    n_p = N_FRAMES - 1
    print(f"main path: {N_FRAMES} frames 1920x1080, deblock264 launches "
          f"{launches}, P frames {n_p}, re-analysed {enc8.n_redo}",
          flush=True)
    if launches != n_p + enc8.n_redo or launches == 0:
        raise RuntimeError("the main path did not launch deblock264 once "
                           "per analyzed P frame")
    # serial, one frame per dispatch: the comparison stream
    ser, enc1, t_ser, tb_ser, tf_ser = encode(frames, "cuda", 1, 0)
    if main != ser:
        bad = [i for i, (a, b) in enumerate(zip(main, ser)) if a != b]
        raise RuntimeError(f"dispatch_batch=8 stream differs from "
                           f"dispatch_batch=1 at frames {bad}")
    for a, b in ((enc8.recon_y, enc1.recon_y), (enc8.recon_u, enc1.recon_u),
                 (enc8.recon_v, enc1.recon_v)):
        if not torch.equal(a, b):
            raise RuntimeError("final reference planes differ between "
                               "dispatch_batch 8 and 1")
    stream = b"".join(main)
    if not stream.startswith(b"\x00\x00\x00\x01") or \
            min(len(f) for f in main) == 0:
        raise RuntimeError("malformed annex-B stream")
    cpu, _, t_cpu, _, _ = encode(frames[:N_CPU], "cpu", 1, 0)
    if cpu != main[:N_CPU]:
        bad = [i for i, (a, b) in enumerate(zip(cpu, main)) if a != b]
        raise RuntimeError(f"GPU stream differs from the CPU stream at "
                           f"frames {bad}")
    kbit = len(stream) * 8 / N_FRAMES / 1000
    print(f"main path ({label}): warm, dispatch_batch=8 pipelined "
          f"{N_FRAMES / t_main:.2f} fps ({enc8.n_redo} re-analysed), "
          f"dispatch_batch=1 serial {N_FRAMES / t_ser:.2f} fps (both incl. "
          f"the IDR), {kbit:.1f} kbit/frame; streams equal; first {N_CPU} "
          f"frames equal the CPU stream ({t_cpu:.1f} s on the CPU)",
          flush=True)
    print(f"serial run ({label}): begin_frame {tb_ser / N_FRAMES * 1e3:.1f} "
          f"ms/frame (upload, dispatch; the IDR's native I slice), "
          f"finish_frame {tf_ser / N_FRAMES * 1e3:.1f} ms/frame (wait for "
          f"the device, fetch, native CABAC)", flush=True)
    return launches, enc1


def kernel_on_path_input(what, label, enc, frame, clock_hz):
    """The kernel on a path's own P frame inputs: one analyzer call
    (deblock on, 8x8, the encoder's qp) on `frame` (host planes at the
    encoder's size) against the encoder's final references; its
    unfiltered recon, mv, nnz and t8 go to the kernel, which must give
    the analyzer's filtered planes and the plain version's.  Returns
    (kernel ms, bound, chain floor)."""
    import torch
    from handbrake_tpu_torch.codecs.h264 import deblock_cuda
    from handbrake_tpu_torch.codecs.h264.analyzer import build_p_analyzer
    from handbrake_tpu_torch.codecs.h264.deblock import deblock_scal
    from handbrake_tpu_torch.codecs.h264.deblock_torch import (compute_bs,
                                                               deblock_plain)
    from handbrake_tpu_torch.codecs.h264.transform import chroma_qp
    src = torch.from_numpy(np.concatenate(
        [enc._pad_to_mb(p, m).ravel() for p, m in zip(frame, (16, 8, 8))]
    )).cuda()
    qp = enc.cfg.qp
    qpc = chroma_qp(qp, enc.cfg.chroma_qp_offset)
    d = build_p_analyzer(enc.mb_w, enc.mb_h, deblock=True,
                         transform8x8=True)(
        src, enc.recon_y, enc.recon_u, enc.recon_v, qp, qpc)
    planes = (d["recon_y_nf"], d["urec_nf"], d["vrec_nf"])
    mv, nnz, t8 = d["mv"], d["luma_nnz"].to(torch.int32), d["t8"].bool()
    scal = deblock_scal(qp, qpc)
    outs, largs = deblock_cuda.prepare(*planes, mv, nnz, None, t8, scal,
                                       False)
    ms = kernel_ms(largs)
    bs_v, bs_h = compute_bs(enc.mb_w, enc.mb_h, mv, nnz, None, t8)
    want = deblock_plain(*planes, bs_v, bs_h, scal, False)
    for got, w, an in zip(outs, want, (d["recon_y"], d["urec"], d["vrec"])):
        if not (torch.equal(got, w) and torch.equal(got, an)):
            raise RuntimeError(f"deblock264 on {what} input differs from "
                               f"its plain version or the analyzer's output")
    b = bounds(planes, bs_v, bs_h, enc.mb_w, enc.mb_h, clock_hz)
    print(f"deblock264 on a {what} P frame's inputs ({enc.mb_w}x{enc.mb_h} "
          f"MBs, qp {qp}) ({label}): kernel {ms:.4f} ms ({KERNEL_REPS} "
          f"back-to-back launches, CUDA events); equal to the plain version "
          f"and the analyzer's output; bS > 0 at "
          f"{int((bs_v > 0).sum() + (bs_h > 0).sum())} of "
          f"{bs_v.numel() + bs_h.numel()} luma edge groups; bound "
          f"{b['bound_ms'] * 1e3:.2f} us by {b['bound_by']}, chain floor "
          f"{b['chain_floor_us']:.1f} us", flush=True)
    return ms, b


def phase_main_path_input(label, enc, clock_hz):
    """Step 4: the kernel on the clip's next frame (make_clip's first
    frames do not depend on n) against the serial encoder's references."""
    from handbrake_tpu_torch.utils.synth import make_clip
    frame = make_clip(W, H, N_FRAMES + 1)[N_FRAMES]
    return kernel_on_path_input("main-path", label, enc, frame, clock_hz)


def read_mp4(path):
    """(track info, annex-B samples) of the video track of an mp4."""
    from handbrake_tpu_torch.sources.mp4 import MP4Demuxer
    d = MP4Demuxer(path)
    try:
        return d.tracks[0], [bytes(b.data) for t, b in d.packets() if t == 0]
    finally:
        d.close()


def avcc_parameter_sets(avcc: bytes) -> bytes:
    """The SPS and PPS NALs of an avcC record, as annex-B."""
    out, i = [], 5
    for mask in (0x1F, 0xFF):               # SPS list, then PPS list
        n = avcc[i] & mask
        i += 1
        for _ in range(n):
            ln = int.from_bytes(avcc[i:i + 2], "big")
            out.append(b"\x00\x00\x00\x01" + avcc[i + 2:i + 2 + ln])
            i += 2 + ln
    return b"".join(out)


def equal_stream(want, avcc, samples) -> bool:
    """An encoder's frames (annex-B, the first with SPS and PPS) equal the
    mp4's avcC parameter sets and samples, sample for sample."""
    from handbrake_tpu_torch.mux.nal import strip_parameter_sets
    return (len(want) == len(samples)
            and avcc_parameter_sets(avcc) + b"".join(samples)
            == b"".join(want)
            and all(strip_parameter_sets(w) == s
                    for w, s in zip(want, samples)))


def with_bars(picture):
    """A letterboxed source frame: `picture` between the black bars."""
    from handbrake_tpu_torch.tools.profile_job import JOB_BAR
    return tuple(np.concatenate([np.full((b, p.shape[1]), fill, np.uint8), p,
                                 np.full((b, p.shape[1]), fill, np.uint8)])
                 for p, b, fill in zip(picture, (JOB_BAR, JOB_BAR // 2,
                                                 JOB_BAR // 2),
                                       (16, 128, 128)))


def phase_letterbox_job(tmp, label):
    """(a): the 2160p letterboxed y4m through the CLI; its first N_CPU
    samples held against the port's CPU encoder on the planes and qp the
    job's encoder was given.  Returns the job's numbers, its encoder, and
    the source's first and next (34th) frames."""
    import dataclasses
    from handbrake_tpu_torch.cli.__main__ import main as cli_main
    from handbrake_tpu_torch.codecs.h264 import deblock_cuda
    from handbrake_tpu_torch.codecs.h264.encoder import H264Encoder
    from handbrake_tpu_torch.filters import resample_cuda
    from handbrake_tpu_torch.job import schema as S
    from handbrake_tpu_torch.tools import profile_job as pj
    # one frame more than the job: the next P frame of (e)
    frames = pj.letterbox_frames(N_FRAMES + 1)
    src = os.path.join(tmp, "letterbox.y4m")
    out = os.path.join(tmp, "letterbox.mp4")
    pj.write_letterbox(src, frames[:N_FRAMES])
    # the source's first N_CPU frames, for the CPU run of the same job
    src_cpu = os.path.join(tmp, "letterbox_cpu.y4m")
    out_cpu = os.path.join(tmp, "letterbox_cpu.mp4")
    pj.write_letterbox(src_cpu, frames[:N_CPU])
    first, nxt = with_bars(frames[0]), with_bars(frames[N_FRAMES])
    del frames
    with pj.JobSpy(keep=N_CPU) as spy:
        reset_counts()
        t0 = time.perf_counter()
        rc = cli_main(pj.letterbox_argv(src, out))
        t_cli = time.perf_counter() - t0
        launches = deblock_cuda.launches
        rs_launches = resample_cuda.launches
    if rc != 0:
        raise RuntimeError(f"the CLI job failed with exit code {rc}")
    cs = next(f.settings for f in spy.job.filters
              if f.id == S.FILTER_CROP_SCALE)
    crop = tuple(cs[k] for k in ("crop-top", "crop-bottom", "crop-left",
                                 "crop-right"))
    ti, samples = read_mp4(out)
    size = (ti.width, ti.height)
    n_p = spy.p_frames()
    print(f"job (a): {pj.JOB_W}x{pj.JOB_H} letterboxed y4m, CLI -e h264 -q "
          f"{pj.JOB_Q} --encoder-profile high, preset Fast 1080p30: scan "
          f"found crop {'/'.join(map(str, crop))} (top/bottom/left/right); "
          f"mp4 {len(samples)} samples at {size[0]}x{size[1]}, avcC "
          f"{len(ti.extradata)} B; deblock264 launches {launches}, P frames "
          f"{n_p}, re-analysed {spy.enc.n_redo}; resample launches "
          f"{rs_launches} (one a frame, for its 3 planes)", flush=True)
    if crop != (pj.JOB_BAR, pj.JOB_BAR, 0, 0):
        raise RuntimeError("the scan did not autocrop the bars exactly")
    if size != JOB_OUT or size != (cs["width"], cs["height"]):
        raise RuntimeError(f"the mp4 is {size}, not the preset's {JOB_OUT}")
    if len(samples) != N_FRAMES or not ti.extradata.startswith(b"\x01"):
        raise RuntimeError("the mp4 lacks samples or its avcC")
    if launches != n_p + spy.enc.n_redo or launches == 0:
        raise RuntimeError("the job did not launch deblock264 once per "
                           "analysed P frame")
    if rs_launches != N_FRAMES:
        raise RuntimeError("the job did not launch the resample kernel once "
                           "a frame (its three planes in one launch)")
    # the port's CPU encoder (compute_bs + deblock_plain in its P frames)
    # on the scaled planes the job encoded: frame 2 is coded against
    # frame 1's deblocked reference, so its bytes hold the kernel to the
    # plain version at this coded size
    cpu = H264Encoder(dataclasses.replace(spy.enc.cfg), device="cpu")
    t0 = time.perf_counter()
    want = [cpu.encode_frame(y, u, v, qp=qp) for y, u, v, qp in spy.frames]
    t_cpu = time.perf_counter() - t0
    same = equal_stream(want, ti.extradata, samples[:N_CPU])
    print(f"job (a): first {len(want)} samples equal the port's CPU encoder "
          f"on the planes the job encoded: {same} ({t_cpu:.1f} s on the "
          f"CPU)", flush=True)
    if len(want) != N_CPU or not same:
        raise RuntimeError("job (a)'s first frames differ from the CPU "
                           "encoder's on the same scaled planes")
    # the whole job on the CPU (scan, crop/scale by the resample's plain
    # version, the encoder with its plain deblock): its samples must equal
    # the card's, byte for byte
    t0 = time.perf_counter()
    rc = cli_main(pj.letterbox_argv(src_cpu, out_cpu) + ["--device", "cpu"])
    t_cpu_job = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"the CPU run of job (a) failed with exit code "
                           f"{rc}")
    ti_cpu, samples_cpu = read_mp4(out_cpu)
    same_job = (ti_cpu.extradata == ti.extradata
                and samples_cpu == samples[:N_CPU])
    print(f"job (a): the port's CPU run of the same job (CLI --device cpu, "
          f"the source's first {N_CPU} frames): {len(samples_cpu)} samples "
          f"at {ti_cpu.width}x{ti_cpu.height}, equal to the card's first "
          f"{N_CPU} byte for byte: {same_job} ({t_cpu_job:.1f} s on the "
          f"CPU)", flush=True)
    if len(samples_cpu) != N_CPU or not same_job:
        raise RuntimeError("job (a) on the card differs from its CPU run")
    print(f"job (a) ({label}): do_job {spy.seconds:.2f} s, "
          f"{N_FRAMES / spy.seconds:.2f} fps ({N_FRAMES} frames incl. the "
          f"IDR; the process's first crop/scale); CLI in all "
          f"(scan of 10 previews + job) {t_cli:.2f} s", flush=True)
    return {"launches": launches, "resample_launches": rs_launches,
            "settings": dict(cs), "first": first, "next": nxt,
            "enc": spy.enc, "seconds": spy.seconds}


def crop_scale_bound(settings):
    """The bound of the crop/scale function on this job's planes, the
    larger of two times: the operations of its banded taps (a multiply
    and an add for each nonzero weight of each output sample, in both
    passes) at the f32 rate, and its bytes (each plane read once and
    written once as u8, the nonzero f32 weights read once) at the memory
    rate.  Also the operations of the dense products the port computes."""
    from handbrake_tpu_torch.filters.kernels import resample_matrix
    from handbrake_tpu_torch.tools.profile_job import JOB_H, JOB_W
    ch = JOB_H - settings["crop-top"] - settings["crop-bottom"]
    cw = JOB_W - settings["crop-left"] - settings["crop-right"]
    oh, ow = settings["height"], settings["width"]
    kind = settings.get("method", "lanczos")
    ops = dense_ops = nbytes = 0
    for h, w, o_h, o_w, shift in ((ch, cw, oh, ow, 0.0),
                                  (ch // 2, cw // 2, oh // 2, ow // 2, -0.25),
                                  (ch // 2, cw // 2, oh // 2, ow // 2, -0.25)):
        taps_v = np.count_nonzero(resample_matrix(h, o_h, kind))
        taps_h = np.count_nonzero(resample_matrix(w, o_w, kind, shift, shift))
        # vertical pass: o_h x w samples; horizontal: o_h x o_w
        ops += 2 * taps_v * w + 2 * taps_h * o_h
        dense_ops += 2 * o_h * h * w + 2 * o_h * w * o_w
        nbytes += h * w + o_h * o_w + 4 * (taps_v + taps_h)
    t_ops = ops / SCALAR_RATE * 1e3
    t_bytes = nbytes / MEM_BW * 1e3
    return {"ops": ops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "dense_ops": dense_ops,
            "dense_ops_ms": dense_ops / SCALAR_RATE * 1e3}


def crop_scale_filter(settings, device):
    """The port's CropScaleFilter with the job's settings on `device`."""
    from handbrake_tpu_torch.core.buffer import Geometry
    from handbrake_tpu_torch.filters.base import FilterInit
    from handbrake_tpu_torch.filters.cropscale import CropScaleFilter
    from handbrake_tpu_torch.tools.profile_job import JOB_H, JOB_W
    f = CropScaleFilter(settings)
    f.init(FilterInit(geometry=Geometry(JOB_W, JOB_H), device=device))
    return f


def scale(f, frame):
    """The filter's planes for one source frame (host planes)."""
    from handbrake_tpu_torch.core.buffer import YUV420P, Buffer
    buf = Buffer(planes=list(frame), pix_fmt=YUV420P, pts=0, duration=3003)
    return f.work(buf)[0].planes


def dense_resample(planes, settings):
    """The library call for the resample of (a)'s planes: out = A_v @ img
    @ A_h^T as two dense f32 ``torch.matmul`` products (TF32 off), then
    round, clip and cast, as the JAX package computes it.  Timed beside
    the kernel; the port never calls it."""
    import torch
    from handbrake_tpu_torch.filters.kernels import resample_matrix
    oh, ow = settings["height"], settings["width"]
    kind = settings.get("method", "lanczos")
    mats = []
    for p, s in zip(planes, (0.0, -0.25, -0.25)):
        (h, w), (o_h, o_w) = p.shape, ((oh, ow) if s == 0.0 else
                                       (oh // 2, ow // 2))
        mats.append(tuple(torch.from_numpy(m).to(p.device) for m in (
            resample_matrix(h, o_h, kind), resample_matrix(w, o_w, kind, s,
                                                           s))))

    def run():
        return [torch.clamp(torch.round((av @ p.float()) @ ah.T), 0,
                            255).to(torch.uint8)
                for p, (av, ah) in zip(planes, mats)]
    return run


def resample_case(dev, in_h, in_w, out_h, out_w, shift, kind, bits, seed,
                  maxval=None):
    """The kernel against its plain version on one random plane of `bits`
    (uint8 or uint16) on the card, to maxval (default 2^bits - 1); returns
    the largest difference."""
    import torch
    from handbrake_tpu_torch.filters import resample_cuda
    from handbrake_tpu_torch.filters.kernels import (resample_band,
                                                     resample_plain)
    rng = np.random.default_rng(seed)
    mx = maxval or (1 << bits) - 1
    x = torch.from_numpy(rng.integers(0, 1 << bits, (in_h, in_w)).astype(
        np.uint8 if bits == 8 else np.uint16)).to(dev)
    bands = [torch.from_numpy(b).to(dev) for b in
             resample_band(in_h, out_h, kind)
             + resample_band(in_w, out_w, kind, shift, shift)]
    got = resample_cuda.resample_cuda(x, *bands, mx)
    want = resample_plain(x, *bands, mx)
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise RuntimeError("the resample kernel's output has another shape "
                           "or type than its plain version's")
    return int((got.int() - want.int()).abs().max())


def frame_launch(dev_planes, oh, ow):
    """The resample kernel's one launch for a 4:2:0 frame's three planes
    on the card (lanczos, chroma with its siting shift) to oh x ow luma,
    with the arguments prepared first: (outputs, arguments, bands, a
    function that launches it, the tensors to keep alive)."""
    from handbrake_tpu_torch.filters import resample_cuda
    from handbrake_tpu_torch.filters.kernels import _band
    dev = dev_planes[0].device
    items, bands = [], []
    for p, sh in zip(dev_planes, (0.0, -0.25, -0.25)):
        o_h, o_w = (oh, ow) if sh == 0.0 else (oh // 2, ow // 2)
        bv = _band(p.shape[0], o_h, "lanczos", 0.0, 0.0, dev)
        bh = _band(p.shape[1], o_w, "lanczos", sh, sh, dev)
        pl = resample_cuda.planned(*p.shape, o_h, o_w, "lanczos", (0.0, 0.0),
                                   (sh, sh), 1, 1, dev)
        items.append((p, *bv, *bh, 255, pl))
        bands.append((bv, bh))
    kout, args, keep = resample_cuda.prepare(items)
    lib = resample_cuda.load()

    def launch():
        if lib.resample_frame_launch(*args) != 0:
            raise RuntimeError("resample launch failed")
    return kout, args, bands, launch, (keep, items)


def phase_resample(first, settings, label):
    """(b): CropScaleFilter on (a)'s first frame on the card and on the
    CPU, equal; the resample kernel against its plain version on the
    card, bit for bit; (d) the filter's time per frame on the card, the
    kernel's time on (a)'s planes (one launch for the three, warm and
    with a cold L2) beside the function's bound, the plain version's and
    the dense products' time, and the time to bring the scaled planes to
    the host.  Returns the kernel's numbers."""
    import torch
    from handbrake_tpu_torch.filters import resample_cuda
    from handbrake_tpu_torch.filters.kernels import resample_plain
    from handbrake_tpu_torch.tools import ablate_resample
    on_dev = crop_scale_filter(settings, "cuda")
    got = [p.cpu().numpy() for p in scale(on_dev, first)]
    want = [p.numpy() for p in scale(crop_scale_filter(settings, "cpu"),
                                     first)]
    errs, fracs = [], []
    for g, w in zip(got, want):
        d = np.abs(g.astype(np.int32) - w.astype(np.int32))
        errs.append(int(d.max()))
        fracs.append(float((d != 0).mean()))
    print(f"crop/scale (b): the card against the CPU on (a)'s first frame, "
          f"Y/U/V max_abs_err {errs}, fraction of samples that differ "
          f"{['%.3g' % x for x in fracs]}", flush=True)
    if max(errs) != 0:
        raise RuntimeError("crop/scale on the card differs from the CPU")
    # the kernel against its plain version: (a)'s geometry, odd sizes
    dev = torch.device("cuda")
    t, b, l, r = (settings[k] for k in ("crop-top", "crop-bottom",
                                        "crop-left", "crop-right"))
    oh, ow = settings["height"], settings["width"]
    ch, cw = first[0].shape[0] - t - b, first[0].shape[1] - l - r
    cases = (("(a) luma", ch, cw, oh, ow, 0.0),
             ("(a) chroma", ch // 2, cw // 2, oh // 2, ow // 2, -0.25)) \
        + RS_CASES
    max_err, n_cases = 0, 0
    for i, (what, in_h, in_w, out_h, out_w, shift) in enumerate(cases):
        for kind in RS_KINDS:
            for bits in (8, 10):
                err = resample_case(dev, in_h, in_w, out_h, out_w, shift,
                                    kind, bits, 1000 * i + bits)
                max_err = max(max_err, err)
                n_cases += 1
                if err != 0:
                    raise RuntimeError(
                        f"the resample kernel differs from its plain "
                        f"version: {what} {in_w}x{in_h} to {out_w}x{out_h} "
                        f"{kind} {bits}-bit, max_abs_err {err}")
    for i, (what, in_h, in_w, out_h, out_w, shift, kind, bits,
            mx) in enumerate(RS_RAGGED):
        err = resample_case(dev, in_h, in_w, out_h, out_w, shift, kind,
                            bits, 7000 + i, mx)
        max_err = max(max_err, err)
        n_cases += 1
        if err != 0:
            raise RuntimeError(
                f"the resample kernel differs from its plain version: "
                f"{what} {in_w}x{in_h} to {out_w}x{out_h} {kind} {bits}-bit "
                f"to maxval {mx}, max_abs_err {err}")
    print(f"resample kernel vs its plain version on the card: {n_cases} "
          f"cases ({', '.join(c[0] for c in cases)}; {'/'.join(RS_KINDS)}; "
          f"8 and 10 bits; and {', '.join(c[0] for c in RS_RAGGED)}), "
          f"max_abs_err {max_err}", flush=True)
    out = {"max_abs_err": max_err, "cases": n_cases, "frac_differ": fracs}
    planes = scale(on_dev, first)
    out["filter_ms"] = cuda_ms(lambda: scale(on_dev, first), CS_REPS)
    out["d2h_ms"] = cuda_ms(lambda: [p.cpu() for p in planes], CS_REPS)
    # the kernel alone on (a)'s planes, already on the card: one launch for
    # all three with the arguments prepared first
    dev_planes = [torch.from_numpy(np.ascontiguousarray(
        p[t // s:p.shape[0] - b // s, l // s:p.shape[1] - r // s])).to(dev)
        for p, s in zip(first, (1, 2, 2))]
    kout, args, bands, launch, _keep = frame_launch(dev_planes, oh, ow)
    lib = resample_cuda.load()
    # warm: back-to-back frames; cold: each frame after a 64 MB write
    out["ms"] = ablate_resample.timed(launch)
    # the DVD upscales, warm: random 4:2:0 frames
    out["ms_dvd"] = {}
    for i, (what, in_h, in_w, o_h, o_w) in enumerate(RS_DVD):
        rng = np.random.default_rng(9000 + i)
        frame = [torch.from_numpy(rng.integers(0, 256, (h, w)).astype(
            np.uint8)).to(dev) for h, w in ((in_h, in_w),
                                            (in_h // 2, in_w // 2),
                                            (in_h // 2, in_w // 2))]
        fl = frame_launch(frame, o_h, o_w)     # kept alive while timed
        out["ms_dvd"][what] = ablate_resample.timed(fl[3])
        del fl
        # the bytes bound: each 4:2:0 plane read once and written once
        out.setdefault("bound_dvd_ms", {})[what] = \
            1.5 * (in_h * in_w + o_h * o_w) / MEM_BW * 1e3
    flush = torch.empty(ablate_resample.FLUSH_BYTES, dtype=torch.uint8,
                        device=dev)
    out["cold_ms"] = ablate_resample.timed(launch, flush)
    del flush
    out["smem_bytes"] = args[1]
    out.update(resample_cuda.kernel_attrs(1, 1, lib))
    # the kernel's own device time (CUPTI through torch.profiler), to tell
    # it from the host's time to enqueue the launch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(KERNEL_REPS):
            lib.resample_frame_launch(*args)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "resample_frame" in e.key]
    out["device_ms"] = sum(e.self_device_time_total
                           for e in kern) / KERNEL_REPS / 1e3
    out["kernels_per_frame"] = sum(e.count for e in kern) / KERNEL_REPS
    out["plain_ms"] = cuda_ms(lambda: [
        resample_plain(p, *bv, *bh, 255)
        for p, (bv, bh) in zip(dev_planes, bands)], 3)
    dense = dense_resample(dev_planes, settings)
    out["library_ms"] = cuda_ms(dense, CS_REPS)
    lib_err = max(int((a.int() - k.int()).abs().max())
                  for a, k in zip(dense(), kout))
    out.update(crop_scale_bound(settings))
    print(f"resample (d) ({label}): kernel {out['ms']:.4f} ms per frame on "
          f"(a)'s three planes (one launch, {ablate_resample.REPS} back to "
          f"back, CUDA events), {out['cold_ms']:.4f} ms with a cold L2 "
          f"(median of {ablate_resample.REPS}, "
          f"{ablate_resample.FLUSH_BYTES >> 20} MB written before each); the "
          f"card runs {out['kernels_per_frame']:.0f} kernel a frame, "
          f"{out['device_ms']:.4f} ms (torch.profiler); {out['regs']} "
          f"registers, {out['local_bytes']} local bytes, "
          f"{out['smem_bytes']} B of shared memory a block; bound of the "
          f"function {out['bound_ms'] * 1e3:.2f} us by {out['bound_by']} "
          f"({out['bytes'] / 1e6:.2f} MB at 3.35 TB/s; "
          f"{out['ops'] / 1e9:.3f} GFLOP of banded taps at 67 TFLOP/s f32), "
          f"{out['bound_ms'] / max(out['device_ms'], 1e-9) * 100:.1f} % of "
          f"it (device time); plain "
          f"version {out['plain_ms']:.2f} ms; the dense torch.matmul "
          f"products (library call, TF32 off) {out['library_ms']:.4f} ms "
          f"({out['dense_ops'] / 1e9:.2f} GFLOP), {lib_err} LSB from the "
          f"kernel at most; the filter call {out['filter_ms']:.4f} ms per "
          f"frame (host planes, upload included; median of {CS_REPS}); "
          f"scaled planes to the host {out['d2h_ms']:.4f} ms per frame; the "
          f"kernel on a DVD frame to 1080p (warm, one launch): "
          + ", ".join(f"{k} {v:.4f} ms (bytes bound "
                      f"{out['bound_dvd_ms'][k] * 1e3:.2f} us)"
                      for k, v in out["ms_dvd"].items()), flush=True)
    return out


def phase_letterbox_input(a, label, clock_hz):
    """(e): the kernel on a letterbox P frame's own inputs: the source's
    next frame, scaled on the card as the job scales it, against (a)'s
    final references."""
    f = crop_scale_filter(a["settings"], "cuda")
    frame = [p.cpu().numpy() for p in scale(f, a["next"])]
    return kernel_on_path_input("letterbox-job", label, a["enc"], frame,
                                clock_hz)


def phase_unscaled_job(tmp, label):
    """(c): the 1080p y4m through work.do_job, its samples held against
    the directly driven encoder's stream."""
    from handbrake_tpu_torch import work
    from handbrake_tpu_torch.codecs.h264 import deblock_cuda
    from handbrake_tpu_torch.codecs.h264.encoder import (EncoderConfig,
                                                         H264Encoder)
    from handbrake_tpu_torch.codecs.ratecontrol import RateController
    from handbrake_tpu_torch.tools import profile_job as pj
    from handbrake_tpu_torch.utils.synth import make_clip, write_y4m
    frames = make_clip(W, H, N_FRAMES)
    src = os.path.join(tmp, "unscaled.y4m")
    out = os.path.join(tmp, "unscaled.mp4")
    write_y4m(src, frames, W, H)
    job = pj.unscaled_job(src, out)
    with pj.JobSpy() as spy:
        reset_counts()
        work.do_job(job)
        launches = deblock_cuda.launches
    ti, samples = read_mp4(out)
    cfg = spy.enc.cfg
    rc = RateController("cq", qp=work.quality_to_qp(job.quality))
    direct = H264Encoder(EncoderConfig(
        width=W, height=H, qp=cfg.qp, gop=cfg.gop, fps=cfg.fps,
        deblock=True, cabac=True, transform8x8=True, dispatch_batch=1))
    want = []
    t0 = time.perf_counter()
    for i, f in enumerate(frames):
        want.append(direct.encode_frame(*f, qp=rc.frame_qp(i % cfg.gop == 0)))
    t_direct = time.perf_counter() - t0
    same = equal_stream(want, ti.extradata, samples)
    n_p = spy.p_frames()
    print(f"job (c): {W}x{H} y4m through do_job (H.264 High, quality "
          f"{pj.UNSCALED_Q}, mp4, gop {cfg.gop}, qp {cfg.qp}): "
          f"{len(samples)} samples at {ti.width}x{ti.height}; deblock264 "
          f"launches {launches}, P frames {n_p}, re-analysed "
          f"{spy.enc.n_redo}; equal to the directly driven encoder: {same}",
          flush=True)
    if len(samples) != N_FRAMES or not same:
        raise RuntimeError("the unscaled job's stream differs from the "
                           "directly driven encoder's")
    if launches != n_p + spy.enc.n_redo:
        raise RuntimeError("the unscaled job did not launch deblock264 once "
                           "per analysed P frame")
    print(f"job (c) ({label}): do_job {spy.seconds:.2f} s, "
          f"{N_FRAMES / spy.seconds:.2f} fps ({N_FRAMES} frames incl. the "
          f"IDR); the encoder driven directly, serial (encode_frame, no "
          f"frame in flight, {direct.n_redo} re-analysed) "
          f"{N_FRAMES / t_direct:.2f} fps", flush=True)
    return {"launches": launches, "seconds": spy.seconds}


def phase_job_path(label, clock_hz):
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        a = phase_letterbox_job(tmp, label)
        b = phase_resample(a["first"], a["settings"], label)
        c = phase_unscaled_job(tmp, label)
    ms, _ = phase_letterbox_input(a, label, clock_hz)
    return a, b, c, ms


def host(p) -> np.ndarray:
    import torch
    return p.cpu().numpy() if isinstance(p, torch.Tensor) else np.asarray(p)


def phase_filters(label):
    """6 (a): every filter of the suite on the card and on the CPU over
    its window; (d): its warm ms per frame on the card beside its bytes
    bound.  Returns {name: numbers}."""
    from handbrake_tpu_torch.tools import profile_filters as pf
    out = {}
    for name, fid, st, integer, reads, state in pf.suite():
        frames, fmt, fi_kw = pf.window(name)
        cmp = frames[:2] if name in SLOW_ON_CPU else frames
        _, got = pf.run(fid, st, cmp, fmt, fi_kw, "cuda")
        t0 = time.perf_counter()
        _, want = pf.run(fid, st, cmp, fmt, fi_kw, "cpu")
        t_cpu = time.perf_counter() - t0
        if len(got) != len(want) or [b.pts for b in got] != \
                [b.pts for b in want]:
            raise RuntimeError(f"{name}: the card and the CPU emit different "
                               f"frames")
        err, diff, total = 0, 0, 0
        for g, w in zip(got, want):
            for a, b in zip(g.planes, w.planes):
                a, b = host(a), host(b)
                if a.shape != b.shape or a.dtype != b.dtype:
                    raise RuntimeError(f"{name}: planes of another shape or "
                                       f"type on the card")
                d = np.abs(a.astype(np.int64) - b.astype(np.int64))
                err = max(err, int(d.max()))
                diff += int((d != 0).sum())
                total += d.size
        if err > (0 if integer else 1):
            raise RuntimeError(f"{name} on the card is {err} LSB from the "
                               f"CPU")
        b = pf.bytes_bound(name, frames[0], got[0].planes, reads, state)
        ms = pf.time_filter(fid, st, pf.on_card(frames), fmt, fi_kw)
        h, w = frames[0][0].shape
        print(f"filter {name} ({w}x{h} {fmt}, {len(cmp)} frames, "
              f"{'integer' if integer else 'float'}): card vs CPU "
              f"max_abs_err {err}, share that differs {diff / total:.3g} "
              f"({t_cpu:.1f} s on the CPU); {ms:.4f} ms per frame warm on "
              f"the card ({label}; planes on the card, median of "
              f"{pf.REPS}, CUDA events), bytes bound "
              f"{b['bound_ms'] * 1e3:.2f} us ({b['bytes']} B at 3.35 TB/s)",
              flush=True)
        out[name] = {"max_abs_err": err, "share_differs": diff / total,
                     "ms": ms, "bound_ms": b["bound_ms"], "cpu_s": t_cpu}
    return out


def hqdn3d_bounds(planes, step_cycles, clock_hz) -> dict:
    """One frame's bound (bytes or operations) and chain floor: each
    sample in and out once and its f32 state in and out once; the
    longest plane's horizontal then vertical chain of dependent steps at
    the probe's measured cycles a step and the card's top SM clock."""
    bps = planes[0].element_size()
    n = sum(p.numel() for p in planes)
    t_bytes = n * (2 * bps + 8) / MEM_BW * 1e3
    t_ops = n * HQ_OPS_PER_SAMPLE / SCALAR_RATE * 1e3
    steps = max(p.shape[0] - 1 + p.shape[1] - 1 for p in planes)
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n * (2 * bps + 8), "t_ops": t_ops, "steps": steps,
            "chain_floor_us": steps * step_cycles / clock_hz * 1e6}


def hqdn3d_compare(frames, g_sp, g_tmp, maxval):
    """The kernel against its plain version on the card over `frames`
    (planes there), the f32 state carried from the scaled first frame.
    Returns (max_abs_err, largest state difference, (the kernel's and the
    plain version's final states))."""
    import torch
    from handbrake_tpu_torch.filters import hqdn3d_cuda
    from handbrake_tpu_torch.filters.denoise import hqdn3d_plane
    ka = [p.float() * (255.0 / maxval) for p in frames[0]]
    pa = [a.clone() for a in ka]
    err, state = 0, 0.0
    for planes in frames:
        res = hqdn3d_cuda.hqdn3d_cuda(planes, ka, g_sp, g_tmp, maxval)
        want = [hqdn3d_plane(p, a, gs, gt, maxval)
                for p, a, gs, gt in zip(planes, pa, g_sp, g_tmp)]
        torch.cuda.synchronize()
        for (o, a), (wo, wa) in zip(res, want):
            err = max(err, int((o.int() - wo.int()).abs().max()))
            state = max(state, float((a - wa).abs().max()))
        ka, pa = [a for _, a in res], [a for _, a in want]
    return err, state, (ka, pa)


def phase_hqdn3d_kernel(label, clock_hz):
    """6 (b): the kernel against its plain version on the card over
    HQ_FRAMES consecutive 1080p frames and a 2160p 10-bit pair, the state
    carried; its division over every f32 in [0, 256); its chain probe;
    (d) its time (KERNEL_REPS back-to-back launches) beside its bound and
    the measured chain floor, and the plain version's time.  Returns its
    kernels-line entry."""
    import torch
    from handbrake_tpu_torch.core.buffer import Geometry
    from handbrake_tpu_torch.filters import hqdn3d_cuda
    from handbrake_tpu_torch.filters.base import FilterInit
    from handbrake_tpu_torch.filters.denoise import (DenoiseFilter,
                                                     hqdn3d_plane)
    from handbrake_tpu_torch.job import param
    from handbrake_tpu_torch.job import schema as S
    from handbrake_tpu_torch.utils.synth import make_interlaced_clip
    f = DenoiseFilter(param.generate_filter_settings(S.FILTER_DENOISE,
                                                     "medium"))
    f.init(FilterInit(geometry=Geometry(W, H), device="cpu"))
    g_sp, g_tmp = f.g_sp, f.g_tmp
    frames = [[torch.from_numpy(p).cuda() for p in fr]
              for fr in make_interlaced_clip(W, H, HQ_FRAMES, seed=4)]
    err, state, (ka, pa) = hqdn3d_compare(frames, g_sp, g_tmp, 255)
    print(f"hqdn3d kernel vs its plain version on the card, {HQ_FRAMES} "
          f"frames {W}x{H} 4:2:0 8-bit, state carried: max_abs_err {err}, "
          f"largest f32 state difference {state}", flush=True)
    # 10 bits: the 8-bit clip widened, as profile_filters widens its own
    uhd = [[torch.from_numpy((p.astype(np.uint16) << 2)
                             | (p.astype(np.uint16) & 3)).cuda() for p in fr]
           for fr in make_interlaced_clip(*HQ_UHD, 2, seed=5)]
    err10, state10, _ = hqdn3d_compare(uhd, g_sp, g_tmp, 1023)
    print(f"hqdn3d kernel vs its plain version on the card, 2 frames "
          f"{HQ_UHD[0]}x{HQ_UHD[1]} 4:2:0 10-bit, state carried: "
          f"max_abs_err {err10}, largest f32 state difference {state10}",
          flush=True)
    del uhd
    if err != 0 or state != 0.0 or err10 != 0 or state10 != 0.0:
        raise RuntimeError("the hqdn3d kernel differs from its plain "
                           "version")
    div = hqdn3d_cuda.div_check()
    print(f"hqdn3d division by 255 (RN(a RN(1/255)) with one fma "
          f"correction) against __fdiv_rn, bit for bit, over every f32 in "
          f"[0, 256): {div['checked']} values checked, {div['mismatches']} "
          f"mismatches", flush=True)
    if div["checked"] != 0x43800000 or div["mismatches"] != 0:
        raise RuntimeError(f"the hqdn3d kernel's division differs from "
                           f"__fdiv_rn: {div}")
    probe = {}
    for ieee in (False, True):
        hqdn3d_cuda.chain_probe(64, g_sp[0], ieee)      # loads the function
        probe[ieee] = hqdn3d_cuda.chain_probe(HQ_PROBE_STEPS, g_sp[0], ieee)
    cycles = probe[False]["cycles"]
    print(f"hqdn3d chain probe ({label}): one warp, {HQ_PROBE_STEPS} "
          f"dependent low-pass steps at luma's spatial gamma "
          f"{g_sp[0]:.4f}, register values only: the kernel's division "
          f"{cycles:.2f} cycles a step (clock64), "
          f"{probe[False]['ms'] * 1e6:.2f} ns (CUDA events, "
          f"{cycles / probe[False]['ms'] / 1e3:.0f} MHz); __fdiv_rn "
          f"{probe[True]['cycles']:.2f} cycles, "
          f"{probe[True]['ms'] * 1e6:.2f} ns", flush=True)
    planes = frames[-1]
    _out, args, _keep = hqdn3d_cuda.prepare(planes, ka, g_sp, g_tmp, 255)
    lib = hqdn3d_cuda.load()
    for _ in range(3):
        if lib.hqdn3d_launch(*args) != 0:
            raise RuntimeError("hqdn3d launch failed")
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(KERNEL_REPS):
        lib.hqdn3d_launch(*args)
    b.record()
    b.synchronize()
    ms = a.elapsed_time(b) / KERNEL_REPS
    plain_ms = cuda_ms(lambda: [hqdn3d_plane(p, q, gs, gt, 255) for
                                p, q, gs, gt in zip(planes, pa, g_sp, g_tmp)],
                       1)
    bd = hqdn3d_bounds(planes, cycles, clock_hz)
    floor_ms = bd["chain_floor_us"] / 1e3
    print(f"hqdn3d kernel at {W}x{H} 4:2:0 ({label}): {ms:.4f} ms a frame "
          f"({KERNEL_REPS} back-to-back calls of its two launches, CUDA "
          f"events); bound {bd['bound_ms'] * 1e3:.2f} us by "
          f"{bd['bound_by']} ({bd['bytes']} B at 3.35 TB/s; operations "
          f"{bd['t_ops'] * 1e3:.2f} us); measured chain floor "
          f"{bd['chain_floor_us']:.1f} us ({bd['steps']} steps x "
          f"{cycles:.2f} cycles at {clock_hz / 1e6:.0f} MHz); the kernel "
          f"{ms / floor_ms:.3f}x the floor; plain version {plain_ms:.1f} ms",
          flush=True)
    return {"name": "hqdn3d", "route": "cuda",
            "source": "handbrake_tpu_torch/csrc/hqdn3d.cu",
            "replaces": "handbrake_tpu/filters/denoise.py:40",
            "equal": max(err, err10) == 0, "max_abs_err": max(err, err10),
            "max_state_diff": max(state, state10), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bd["bound_ms"],
            "bound_us": bd["bound_ms"] * 1e3, "bound_by": bd["bound_by"],
            "chain_floor_us": bd["chain_floor_us"],
            "chain_cycles_per_step": cycles,
            "chain_cycles_per_step_fdiv_rn": probe[True]["cycles"],
            "x_chain_floor": ms / floor_ms,
            "div_checked": div["checked"],
            "div_mismatches": div["mismatches"], "library_ms": None}


def phase_interlaced_job(tmp, label):
    """6 (c): the woven 1080i y4m through the CLI with comb detection,
    decomb and hqdn3d.  Returns its numbers."""
    import dataclasses
    from handbrake_tpu_torch.cli.__main__ import main as cli_main
    from handbrake_tpu_torch.codecs.h264 import deblock_cuda
    from handbrake_tpu_torch.codecs.h264.encoder import H264Encoder
    from handbrake_tpu_torch.filters import hqdn3d_cuda
    from handbrake_tpu_torch.tools import profile_job as pj
    from handbrake_tpu_torch.utils.synth import (make_interlaced_clip,
                                                 write_y4m)
    src = os.path.join(tmp, "woven.y4m")
    out = os.path.join(tmp, "woven.mp4")
    write_y4m(src, make_interlaced_clip(W, H, N_FRAMES), W, H, interlace="t")
    argv = ["-i", src, "-o", out, "--comb-detect", "--decomb", "--hqdn3d",
            "-e", "h264", "-q", "28", "--encoder-profile", "high"]
    with pj.JobSpy(keep=N_CPU) as spy:
        reset_counts()
        t0 = time.perf_counter()
        rc = cli_main(argv)
        t_cli = time.perf_counter() - t0
        launches = deblock_cuda.launches
        hq = hqdn3d_cuda.launches
    if rc != 0:
        raise RuntimeError(f"the 1080i CLI job failed with exit code {rc}")
    ti, samples = read_mp4(out)
    n_p = spy.p_frames()
    names = [f.id for f in spy.job.filters]
    print(f"job 1080i: {W}x{H} woven y4m (It), CLI {' '.join(argv[4:])}, "
          f"preset Fast 1080p30, filters {names}: mp4 {len(samples)} samples "
          f"at {ti.width}x{ti.height}; deblock264 launches {launches}, P "
          f"frames {n_p}, re-analysed {spy.enc.n_redo}; hqdn3d launches "
          f"{hq}", flush=True)
    if len(samples) != N_FRAMES or (ti.width, ti.height) != (W, H):
        raise RuntimeError("the 1080i job's mp4 lacks samples or has "
                           "another size")
    if launches != n_p + spy.enc.n_redo or launches == 0:
        raise RuntimeError("the 1080i job did not launch deblock264 once per "
                           "analysed P frame")
    if hq != N_FRAMES:
        raise RuntimeError("the 1080i job did not launch hqdn3d once per "
                           "frame")
    cpu = H264Encoder(dataclasses.replace(spy.enc.cfg), device="cpu")
    want = [cpu.encode_frame(y, u, v, qp=qp) for y, u, v, qp in spy.frames]
    same = equal_stream(want, ti.extradata, samples[:N_CPU])
    print(f"job 1080i: first {len(want)} samples equal the port's CPU "
          f"encoder on the planes the job encoded: {same}", flush=True)
    if len(want) != N_CPU or not same:
        raise RuntimeError("the 1080i job's first frames differ from the CPU "
                           "encoder's on the same planes")
    print(f"job 1080i ({label}): do_job {spy.seconds:.2f} s, "
          f"{N_FRAMES / spy.seconds:.2f} fps ({N_FRAMES} frames incl. the "
          f"IDR); CLI in all (scan + job) {t_cli:.2f} s", flush=True)
    return {"launches": launches, "hqdn3d_launches": hq,
            "fps": N_FRAMES / spy.seconds}


def phase_filter_suite(label, clock_hz):
    filters = phase_filters(label)
    entry = phase_hqdn3d_kernel(label, clock_hz)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        job = phase_interlaced_job(tmp, label)
    entry.update(launches=job["hqdn3d_launches"],
                 launches_per_frame=job["hqdn3d_launches"] / N_FRAMES)
    return filters, job, entry


def read_mkv(path):
    """(track info, annex-B samples) of the video track of an mkv."""
    from handbrake_tpu_torch.sources.mkv import MKVDemuxer
    d = MKVDemuxer(path)
    try:
        return d.tracks[0], [bytes(b.data) for t, b in d.packets() if t == 0]
    finally:
        d.close()


def decode_all(samples, extradata=b"", codec="h264"):
    """The port's decoder (the registry's, fed as a job feeds it) on a
    track's samples; returns the frames' planes and the host seconds."""
    from handbrake_tpu_torch.codecs.registry import create_video_decoder
    from handbrake_tpu_torch.core.buffer import Buffer
    dec = create_video_decoder(codec, extradata)
    frames = []
    t0 = time.perf_counter()
    for i, smp in enumerate(samples):
        frames += [f.planes for f in dec.feed(Buffer(data=smp, pts=i))]
    frames += [f.planes for f in dec.flush()]
    return frames, time.perf_counter() - t0


def phase_h264_source(tmp, label):
    """7: the H.264-source job at 1080p.  Returns its numbers."""
    import torch
    from handbrake_tpu_torch.cli.__main__ import main as cli_main
    from handbrake_tpu_torch.codecs.h264 import deblock_cuda
    from handbrake_tpu_torch.codecs.h264.encoder import (EncoderConfig,
                                                         H264Encoder)
    from handbrake_tpu_torch.mux.mp4 import MP4Writer
    from handbrake_tpu_torch.tools import profile_job as pj
    from handbrake_tpu_torch.utils.synth import make_clip
    # (a) the source stream, encoded on the card, with its recons
    frames = make_clip(W, H, SRC_N, seed=9)
    enc = H264Encoder(EncoderConfig(width=W, height=H, qp=QP, gop=600,
                                    deblock=True, cabac=True,
                                    transform8x8=True))
    stream, recons = [], []
    for f in frames:
        stream.append(enc.encode_frame(*f))
        recons.append(tuple(p[:n_h, :n_w].cpu().numpy() for p, n_h, n_w in
                            zip((enc.recon_y, enc.recon_u, enc.recon_v),
                                (H, H // 2, H // 2), (W, W // 2, W // 2))))
    decoded, t_dec = decode_all(stream)
    same = len(decoded) == SRC_N and all(
        all(np.array_equal(a, b) for a, b in zip(d, r))
        for d, r in zip(decoded, recons))
    dec_ms = t_dec / SRC_N * 1e3
    print(f"H.264 source: {SRC_N} frames {W}x{H} encoded on the card (High, "
          f"qp {QP}); the port's decoder gives back {len(decoded)} frames, "
          f"equal to the encoder's reconstructions: {same}; decoder "
          f"{dec_ms:.2f} ms per 1080p frame on the host ({label})",
          flush=True)
    if not same:
        raise RuntimeError("the decoder's frames differ from the encoder's "
                           "reconstructions")
    src = os.path.join(tmp, "src.mp4")
    w = MP4Writer(src)
    v = w.add_video_track(codec="h264", width=W, height=H)
    for i, au in enumerate(stream):
        w.write_sample(v, au, duration=3003, sync=i == 0, annexb=True)
    w.finalize()
    # (b) the CLI job to mkv, on the card
    argv = ["-e", "h264", "-q", "28", "--encoder-profile", "high"]
    out_mkv = os.path.join(tmp, "out.mkv")
    with pj.JobSpy() as spy:
        reset_counts()
        t0 = time.perf_counter()
        rc = cli_main(["-i", src, "-o", out_mkv] + argv)
        t_cli = time.perf_counter() - t0
        launches = deblock_cuda.launches
    if rc != 0:
        raise RuntimeError(f"the H.264-source job failed with exit code {rc}")
    n_p = spy.p_frames()
    ti, mkv_samples = read_mkv(out_mkv)
    out_frames, _ = decode_all(mkv_samples, ti.extradata)
    fps = SRC_N / spy.seconds
    print(f"job 7 ({label}): {W}x{H} H.264 mp4 source, CLI -o out.mkv "
          f"{' '.join(argv)}, preset Fast 1080p30: mkv {len(mkv_samples)} "
          f"samples at {ti.width}x{ti.height} ({ti.codec}), decoded back to "
          f"{len(out_frames)} frames; deblock264 launches {launches}, P "
          f"frames {n_p}, re-analysed {spy.enc.n_redo}; do_job "
          f"{spy.seconds:.2f} s, {fps:.2f} fps; CLI in all (scan + job) "
          f"{t_cli:.2f} s", flush=True)
    if len(mkv_samples) != SRC_N or (ti.width, ti.height) != (W, H) or \
            len(out_frames) != SRC_N or \
            out_frames[0][0].shape != (H, W) or ti.codec != "h264":
        raise RuntimeError("the mkv lacks samples or frames, or has another "
                           "size")
    if launches != n_p + spy.enc.n_redo or launches == 0:
        raise RuntimeError("the H.264-source job did not launch deblock264 "
                           "once per analysed P frame")
    # (c) the same job to mp4: the same samples
    out_mp4 = os.path.join(tmp, "out.mp4")
    if cli_main(["-i", src, "-o", out_mp4, "-f", "mp4"] + argv) != 0:
        raise RuntimeError("the H.264-source job to mp4 failed")
    ti4, mp4_samples = read_mp4(out_mp4)
    same_mux = mp4_samples == mkv_samples and ti4.extradata == ti.extradata
    print(f"job 7: the same job with -f mp4: {len(mp4_samples)} samples, "
          f"equal to the mkv's (and its avcC to the mkv's CodecPrivate): "
          f"{same_mux}", flush=True)
    if not same_mux:
        raise RuntimeError("the mkv and mp4 of the same job differ")
    # (d) the mkv as a source: scan and transcode again
    again = os.path.join(tmp, "again.mp4")
    with pj.JobSpy() as spy2:
        t0 = time.perf_counter()
        rc = cli_main(["-i", out_mkv, "-o", again] + argv)
        t_again = time.perf_counter() - t0
    ti2, again_samples = read_mp4(again)
    print(f"job 7: the mkv as a source, through the CLI to mp4: "
          f"{len(again_samples)} samples at {ti2.width}x{ti2.height}; "
          f"do_job {spy2.seconds:.2f} s, {SRC_N / spy2.seconds:.2f} fps; "
          f"CLI in all {t_again:.2f} s", flush=True)
    if rc != 0 or len(again_samples) != SRC_N or \
            (ti2.width, ti2.height) != (W, H):
        raise RuntimeError("the mkv source did not transcode")
    torch.cuda.synchronize()
    return {"launches": launches, "fps": fps, "decoder_ms": dec_ms,
            "mkv_source_fps": SRC_N / spy2.seconds}, stream


def tone(sr, ch, n, seed):
    """Tones (one a channel) plus noise, float32 (n, ch)."""
    t = np.arange(n) / sr
    rng = np.random.default_rng(seed)
    return np.stack([0.4 * np.sin(2 * np.pi * (440 + 110 * c) * t)
                     + 0.02 * rng.standard_normal(n) for c in range(ch)],
                    1).astype(np.float32)


def dac3(enc) -> bytes:
    """The dac3 payload of an AC-3 encoder's stream."""
    v = (enc.fscod << 22) | (8 << 17) | (enc.acmod << 11) \
        | (enc.lfeon << 10) | ((enc.frmsizecod >> 1) << 5)
    return v.to_bytes(3, "big")


def audio_source(path, stream):
    """8 (a): the H.264 stream (annex-B, SPS and PPS in the first access
    unit) in an mp4 with three sound tracks as long as the video: AAC
    stereo 48 kHz (the port's AACEncoder), AC-3 5.1 48 kHz (its
    Ac3Encoder) and PCM s16le stereo 44.1 kHz, each interleaved with the
    frames it sounds under.  Returns each track's (codec, rate, channels,
    extradata, [(payload, samples)]) and its PCM."""
    from handbrake_tpu_torch.audio.aac import AACEncoder
    from handbrake_tpu_torch.audio.ac3enc import Ac3Encoder
    from handbrake_tpu_torch.mux.mp4 import MP4Writer
    n = len(stream)
    secs = n * FRAME_TICKS / 90000
    pcm = [tone(48000, 2, int(48000 * secs), 11),
           tone(48000, 6, int(48000 * secs), 12),
           tone(44100, 2, int(44100 * secs), 13)]
    aac = AACEncoder(48000, 2)
    ac3 = Ac3Encoder(48000, 6, AC3_SRC_BPS)
    s16 = np.clip(pcm[2] * 32767, -32768, 32767).astype("<i2")
    tracks = [
        ("aac", 48000, 2, aac.audio_specific_config(),
         [(au, 1024) for au in aac.encode(pcm[0]) + aac.flush()]),
        ("ac3", 48000, 6, dac3(ac3),
         [(f, 1536) for f in ac3.encode(pcm[1]) + ac3.flush()]),
        ("pcm_s16le", 44100, 2, b"",
         [(s16[i:i + 1470].tobytes(), len(s16[i:i + 1470]))
          for i in range(0, len(s16), 1470)])]
    w = MP4Writer(path)
    vi = w.add_video_track(codec="h264", width=W, height=H)
    ais = [w.add_audio_track(codec=c, sample_rate=sr, channels=ch,
                             extradata=xd) for c, sr, ch, xd, _ in tracks]
    for i, au in enumerate(stream):
        w.write_sample(vi, au, duration=FRAME_TICKS, sync=i == 0,
                       annexb=True)
        for ai, (_c, sr, _ch, _xd, pkts) in zip(ais, tracks):
            t0 = i * FRAME_TICKS * sr // 90000
            t1 = (i + 1) * FRAME_TICKS * sr // 90000
            pos = 0
            for data, k in pkts:
                if t0 <= pos < t1 or (i == n - 1 and pos >= t1):
                    w.write_sample(ai, data, duration=k)
                pos += k
    w.finalize()
    return tracks, pcm


def read_tracks(path):
    """Each track's info and (pts, payload) packets, of an mp4 or mkv."""
    from handbrake_tpu_torch.sources.mkv import MKVDemuxer
    from handbrake_tpu_torch.sources.mp4 import MP4Demuxer
    d = MKVDemuxer(path) if path.endswith(".mkv") else MP4Demuxer(path)
    try:
        pk = {}
        for trk, b in d.packets():
            pk.setdefault(trk, []).append((b.pts, bytes(b.data)))
        return list(d.tracks), pk
    finally:
        d.close()


def host_chain(src, track, spec):
    """The packets that the port's AudioChain gives on the host for one
    source track: its packets through the job's decoder, then the chain,
    outside any job."""
    from handbrake_tpu_torch import work
    from handbrake_tpu_torch.audio.chain import AudioChain
    from handbrake_tpu_torch.core.buffer import Buffer
    tracks, pk = read_tracks(src)
    ti = tracks[track]
    dec = work._make_audio_decoder(ti, spec)
    chain = AudioChain(spec, ti)
    out = []
    for pts, data in pk[track]:
        for b in dec.feed(Buffer(data=data, pts=pts, track_kind="audio")):
            out += chain.process(b)
    out += chain.flush()
    return [bytes(p.data) for p in out]


def encoder_speed():
    """Host seconds per second of 48 kHz stereo audio of the AAC (also
    with its MDCT matrix rebuilt on every call, as the JAX package does:
    the same bytes), AC-3 and FLAC encoders."""
    from handbrake_tpu_torch.audio import aac
    from handbrake_tpu_torch.audio.ac3enc import Ac3Encoder
    from handbrake_tpu_torch.audio.flac import FlacEncoder
    pcm = tone(48000, 2, int(48000 * SPEED_SECONDS), 21)
    s16 = np.clip(pcm * 32767, -32768, 32767).astype(np.int32)

    def rebuilt(frames):
        return frames @ aac._mdct_matrix()

    def run(make, feed):
        enc = make()
        t0 = time.perf_counter()
        out = feed(enc)
        return out, (time.perf_counter() - t0) / SPEED_SECONDS

    def aac_feed(e):
        return e.encode(pcm) + e.flush()
    cached, t_aac = run(lambda: aac.AACEncoder(48000, 2, bitrate=160000),
                        aac_feed)
    cached_mdct = aac._mdct_long
    aac._mdct_long = rebuilt
    try:
        slow, t_aac_rebuilt = run(
            lambda: aac.AACEncoder(48000, 2, bitrate=160000), aac_feed)
    finally:
        aac._mdct_long = cached_mdct
    if slow != cached:
        raise RuntimeError("the AAC encoder's bytes depend on where its "
                           "MDCT matrix is built")
    _, t_ac3 = run(lambda: Ac3Encoder(48000, 2, 192000),
                   lambda e: e.encode(pcm) + e.flush())
    _, t_flac = run(lambda: FlacEncoder(48000, 2, 16),
                    lambda e: e.encode(s16) + e.flush())
    return {"aac": t_aac, "aac_mdct_rebuilt_each_call": t_aac_rebuilt,
            "ac3": t_ac3, "flac": t_flac}


def phase_audio(tmp, label, stream):
    """8: audio jobs on the card: (a) the source; (b) the CLI's default
    preset (AAC stereo 160 from track 1) to mp4, and the same job with -a
    none; (c) three tracks to mkv (copy:aac, 5.1 AC-3 to stereo FLAC, 44.1
    kHz PCM to 48 kHz AC-3); (d) the jobs' fps, the audio stages' host
    time and the audio encoders' speed.  Returns its numbers."""
    from handbrake_tpu_torch.audio.aacdec import AACDecoder
    from handbrake_tpu_torch.audio.ac3dec import Ac3Decoder
    from handbrake_tpu_torch.audio.dsp import apply_mixdown
    from handbrake_tpu_torch.audio.flac import FlacDecoder
    from handbrake_tpu_torch.cli.__main__ import main as cli_main
    from handbrake_tpu_torch.codecs.h264 import deblock_cuda
    from handbrake_tpu_torch.tools import profile_job as pj
    n = len(stream)
    src = os.path.join(tmp, "av.mp4")
    tracks, pcm = audio_source(src, stream)
    _src_tracks, src_pk = read_tracks(src)
    print(f"audio (a): {W}x{H} H.264 mp4 of {n} frames with "
          + ", ".join(f"{c} {sr} Hz {ch} ch ({len(p)} packets)"
                      for c, sr, ch, _x, p in tracks), flush=True)
    argv = ["-e", "h264", "-q", "28", "--encoder-profile", "high"]

    def job(out, *extra):
        with pj.JobSpy() as spy, pj.StageTimers() as st:
            reset_counts()
            rc = cli_main(["-i", src, "-o", out, *argv, *extra])
            launches = deblock_cuda.launches
        if rc != 0:
            raise RuntimeError(f"the audio job {extra} failed: exit {rc}")
        want = spy.p_frames() + spy.enc.n_redo
        if launches == 0 or launches != want:
            raise RuntimeError(f"the audio job {extra} did not launch "
                               f"deblock264 once per analysed P frame "
                               f"({launches}, {want})")
        return spy, dict(st.sec), launches

    # (b) the default preset, and the same job without sound
    out_b = os.path.join(tmp, "b.mp4")
    spy_b, sec_b, launches_b = job(out_b)
    out_none = os.path.join(tmp, "none.mp4")
    spy_n, _sec_n, _ = job(out_none, "-a", "none")
    tb, pb = read_tracks(out_b)
    tn, pn = read_tracks(out_none)
    spec = spy_b.job.audio[0]
    aac_out = [p for _pts, p in pb[1]]
    # samples decoded from each AAC track after its priming frame: the
    # output's against the source's (the PCM the job was given)
    dec = AACDecoder(tb[1].extradata)
    n_dec = sum(dec.decode_frame(p).shape[0] for p in aac_out) - 1024
    dec = AACDecoder(tracks[0][3])
    n_src = sum(dec.decode_frame(p).shape[0] for p, _k in tracks[0][4]) \
        - 1024
    host = host_chain(src, 1, spec)
    video_same = pb[0] == pn[0]
    checks_b = {
        "tracks": [(t.kind, t.codec) for t in tb] == [("video", "h264"),
                                                      ("audio", "aac")],
        "spec": (spec.encoder, spec.bitrate, spec.mixdown) == ("aac", 160,
                                                               "stereo"),
        "samples": abs(n_dec - n_src) <= 1024,
        "first_pts": pb[1][0][0] == pb[0][0][0],
        "host_chain": aac_out == host,
        "video_unchanged": video_same and len(tn) == 1}
    fps_b, fps_n = n / spy_b.seconds, n / spy_n.seconds
    audio_s = sec_b.get("audio decode", 0.0) + sec_b.get("audio chain", 0.0)
    print(f"audio (b) ({label}): CLI default preset to mp4: {len(aac_out)} "
          f"AAC packets ({spec.encoder} {spec.bitrate} kb/s "
          f"{spec.mixdown}), decoded {n_dec} samples after the priming "
          f"frame against the source track's {n_src} (its PCM "
          f"{len(pcm[0])}); first audio pts "
          f"{pb[1][0][0]}, video {pb[0][0][0]}; packets equal to the host "
          f"AudioChain's: {checks_b['host_chain']}; video samples equal to "
          f"the -a none job's: {video_same}; deblock264 launches "
          f"{launches_b}; do_job {spy_b.seconds:.3f} s, {fps_b:.2f} fps, "
          f"-a none {spy_n.seconds:.3f} s, {fps_n:.2f} fps; host time of "
          f"the audio decoder {sec_b.get('audio decode', 0.0):.3f} s and "
          f"chain {sec_b.get('audio chain', 0.0):.3f} s, begin_frame "
          f"{sec_b.get('begin_frame', 0.0):.3f} s, finish_frame "
          f"{sec_b.get('finish_frame', 0.0):.3f} s", flush=True)
    if not all(checks_b.values()):
        raise RuntimeError(f"audio job (b) failed its checks: {checks_b}")
    # (c) three tracks to mkv
    out_c = os.path.join(tmp, "c.mkv")
    spy_c, _sec_c, launches_c = job(out_c, "-a", "1,2,3", "-E",
                                    "copy:aac,flac,ac3", "-R",
                                    "auto,auto,48")
    tc, pc = read_tracks(out_c)
    flac_dec = FlacDecoder(tc[2].extradata + b"".join(p for _t, p in pc[2]))
    got_flac = flac_dec.decode_all()
    ac3 = Ac3Decoder()
    want_flac = []
    for _pts, data in src_pk[2]:
        for fr in ac3.feed(data):
            mix = apply_mixdown(np.ascontiguousarray(fr.T), "stereo")
            want_flac.append(np.clip(mix * 32767.0, -32768,
                                     32767).astype(np.int32))
    want_flac = np.concatenate(want_flac)
    resampled = sum(int(round(k * 48000 / 44100)) for _d, k in tracks[2][4])
    want_ac3 = -(-resampled // 1536)
    checks_c = {
        "tracks": [(t.kind, t.codec, t.sample_rate if t.kind == "audio"
                    else 0) for t in tc] == [
            ("video", "h264", 0), ("audio", "aac", 48000),
            ("audio", "flac", 48000), ("audio", "ac3", 48000)],
        "copy": [p for _t, p in pc[1]] == [p for _t, p in src_pk[1]],
        "flac": got_flac.shape == want_flac.shape
        and np.array_equal(got_flac, want_flac),
        "ac3_frames": len(pc[3]) == want_ac3}
    print(f"audio (c) ({label}): -a 1,2,3 -E copy:aac,flac,ac3 -R "
          f"auto,auto,48 to mkv: "
          f"track 1 {len(pc[1])} packets equal to the source's: "
          f"{checks_c['copy']}; track 2 FLAC {got_flac.shape[0]} samples x "
          f"{got_flac.shape[1]}, equal to the host's AC-3 decode, stereo "
          f"mixdown and 16-bit quantization: {checks_c['flac']}; track 3 "
          f"{len(pc[3])} AC-3 frames at {tc[3].sample_rate} Hz (expected "
          f"{want_ac3}); deblock264 launches {launches_c}; do_job "
          f"{spy_c.seconds:.3f} s, {n / spy_c.seconds:.2f} fps", flush=True)
    if not all(checks_c.values()):
        raise RuntimeError(f"audio job (c) failed its checks: {checks_c}")
    # (d) the audio encoders' speed on this host
    speed = encoder_speed()
    print(f"audio (d) ({label}): host seconds per second of 48 kHz stereo "
          f"audio: AAC {speed['aac']:.3f} (MDCT matrix rebuilt every call: "
          f"{speed['aac_mdct_rebuilt_each_call']:.3f}, the same bytes), "
          f"AC-3 {speed['ac3']:.3f}, FLAC {speed['flac']:.3f}; job (b)'s "
          f"audio decode and chain {audio_s:.3f} s of its "
          f"{spy_b.seconds:.3f} s", flush=True)
    return {"fps_with_audio": fps_b, "fps_without_audio": fps_n,
            "fps_three_tracks_mkv": n / spy_c.seconds,
            "audio_stage_s": audio_s, "job_s": spy_b.seconds,
            "launches_default": launches_b, "launches_three_tracks": launches_c,
            "encoder_s_per_s": speed}


def card_bandwidth() -> float:
    """The card's own memory rate, bytes/s: its memory clock times its bus
    width, two transfers a clock."""
    import torch
    p = torch.cuda.get_device_properties(0)
    return p.memory_clock_rate * 1e3 * p.memory_bus_width / 8 * 2


def sub_patches(w, h, seed):
    """9 (a)'s patches for a w x h frame, [(label, RGBA uint8, (x0, y0))],
    (x0, y0) clamped into the frame as the filter clamps it: a two-line
    cue from the machine's rasterizer at 1920x1080, a 1600x240 PGS card
    decoded by the port's PgsDecoder, a 1400x200 random-alpha patch at an
    odd offset, and a patch past the right and bottom edges."""
    from handbrake_tpu_torch.filters.rendersub import clamp_site
    from handbrake_tpu_torch.subtitles.pgs import (PgsDecoder,
                                                   build_display_set)
    from handbrake_tpu_torch.subtitles.raster import render_text_rgba
    rng = np.random.default_rng(seed)
    text, (tx, ty) = render_text_rgba(SUB_CUE, 1920, 1080)
    pal = np.zeros((256, 4), np.uint8)
    pal[1:4] = [(235, 128, 128, 255), (81, 90, 240, 200), (40, 200, 90, 128)]
    # blocks of the three colours on a transparent field (one ODS
    # segment holds at most 64 KiB of run-length code)
    yy, xx = np.mgrid[0:240, 0:1600]
    idx = ((yy // 40 + xx // 40) % 4).astype(np.uint8)
    ev = [e for e in PgsDecoder().feed(build_display_set(
        0, idx, pal, 160, 800, screen=(w, h)), 0) if e.rgba is not None][0]
    rand = rng.integers(0, 256, (200, 1400, 4)).astype(np.uint8)
    edge = rng.integers(0, 256, (100, 300, 4)).astype(np.uint8)
    out = []
    for label, rgba, (x0, y0) in (("text", text, (tx, ty)),
                                  ("pgs", ev.rgba, (ev.x, ev.y)),
                                  ("random", rand, (261, 811)),
                                  ("edge", edge, (w - 150, h - 40))):
        out.append((label, np.ascontiguousarray(rgba),
                    clamp_site(x0, y0, rgba.shape[1], rgba.shape[0], w, h)))
    return out


def blend_bound_ms(rgba, sub, bytes_per_sample, bw):
    """The blend's bytes bound: the RGBA read (4P), luma read and written
    (2 P b) and both chroma planes read and written (4 (P / (sw sh)) b),
    at the card's memory rate."""
    ph, pw = rgba.shape[:2]
    p = ph * pw
    sw, sh = sub
    n = 4 * p + 2 * p * bytes_per_sample \
        + 4 * (ph // sh) * (pw // sw) * bytes_per_sample
    return n / bw * 1e3


def phase_blend(label):
    """9 (a): the burn-in's blend on the card against the CPU, byte for
    byte, at 1080p and 2160p, 8 and 10 bits, 4:2:0, 4:2:2 and 4:4:4, on
    each patch; its warm ms and launches per call and bytes bound.
    Returns its numbers."""
    import torch
    from handbrake_tpu_torch.filters.rendersub import blend_rgba
    from handbrake_tpu_torch.subtitles.raster import rasterizer
    dev = torch.device("cuda")
    bw = card_bandwidth()
    print(f"subtitles: text cues are rasterized with {rasterizer()}; the "
          f"card's memory rate {bw / 1e12:.3f} TB/s (clock x bus width; "
          f"the data sheet's {MEM_BW / 1e12:.2f})", flush=True)
    n_cases, timed = 0, {}
    for (w, h) in ((1920, 1080), (3840, 2160)):
        patches = sub_patches(w, h, w)
        for bits in (8, 10):
            mx = (1 << bits) - 1
            dt = np.uint8 if bits == 8 else np.uint16
            for sub in ((2, 2), (2, 1), (1, 1)):
                sw, sh = sub
                rng = np.random.default_rng(w + bits + sw * 3 + sh)
                planes = [rng.integers(0, mx + 1, s).astype(dt) for s in
                          ((h, w), (h // sh, w // sw), (h // sh, w // sw))]
                cpu = [torch.from_numpy(p) for p in planes]
                card_planes = [p.to(dev) for p in cpu]
                for what, rgba, (x0, y0) in patches:
                    kw = dict(x0=x0, y0=y0, sw=sw, sh=sh, maxval=mx)
                    r_cpu = torch.from_numpy(rgba)
                    r_dev = r_cpu.to(dev)
                    got = blend_rgba(*card_planes, r_dev, **kw)
                    want = blend_rgba(*cpu, r_cpu, **kw)
                    diff = [int((g.cpu() != t).sum())
                            for g, t in zip(got, want)]
                    n_cases += 1
                    if any(diff):
                        raise RuntimeError(
                            f"the blend on the card differs from the CPU: "
                            f"{what} {rgba.shape[1]}x{rgba.shape[0]} at "
                            f"({x0}, {y0}) on {w}x{h} {bits}-bit {sw}x{sh},"
                            f" samples differing Y/U/V {diff}")
                    if (w, bits, sub) != (1920, 8, (2, 2)):
                        continue
                    call = (lambda p=card_planes, r=r_dev, k=kw:
                            blend_rgba(*p, r, **k))
                    ms = cuda_ms(call, BLEND_REPS)
                    acts = [torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]
                    with torch.profiler.profile(activities=acts) as prof:
                        for _ in range(3):
                            call()
                        torch.cuda.synchronize()
                    kern = [e for e in prof.key_averages() if e.device_type
                            == torch.autograd.DeviceType.CUDA]
                    timed[what] = {
                        "size": [rgba.shape[1], rgba.shape[0]], "ms": ms,
                        "launches": sum(e.count for e in kern) / 3,
                        "device_ms": sum(e.self_device_time_total
                                         for e in kern) / 3 / 1e3,
                        "bound_ms": blend_bound_ms(rgba, sub, 1, bw)}
    print(f"subtitles 9 (a): blend_rgba on the card equals the CPU byte for "
          f"byte in {n_cases} cases (1080p and 2160p, 8 and 10 bits, 4:2:0, "
          f"4:2:2, 4:4:4; a two-line text cue, a 1600x240 PGS card, a "
          f"1400x200 random-alpha patch at an odd offset, a patch clamped "
          f"at the right and bottom edges)", flush=True)
    for what, t in timed.items():
        print(f"subtitles 9 (a) ({label}): blend of the {what} patch "
              f"{t['size'][0]}x{t['size'][1]} on a 1080p 8-bit 4:2:0 frame: "
              f"{t['ms']:.4f} ms a call (CUDA events, warm), "
              f"{t['launches']:.0f} launches a call, device "
              f"{t['device_ms']:.4f} ms; bytes bound {t['bound_ms'] * 1e3:.3f}"
              f" us", flush=True)
    return {"cases": n_cases, "rasterizer": rasterizer(), "timed": timed,
            "card_bandwidth": bw}


def sub_source(path, stream, n):
    """9 (b)'s source: the first n frames of step 7's 1080p stream in an
    mkv with an S_HDMV/PGS track (a card shown at frame SUB_SHOW, cleared
    at SUB_CLEAR) and an S_TEXT/UTF8 track of SUB_TEXT_CUES."""
    from handbrake_tpu_torch.mux.mkv import MKVWriter
    from handbrake_tpu_torch.subtitles.pgs import build_display_set
    w = MKVWriter(path)
    vi = w.add_video_track(codec="h264", width=W, height=H,
                           fps=30000 / 1001)
    pi = w.add_subtitle_track(codec="pgs")
    ti = w.add_subtitle_track(codec="srt", language="eng")
    pal = np.zeros((256, 4), np.uint8)
    pal[1] = SUB_CARD_YCRCB + (255,)
    card = np.ones((SUB_RECT[3], SUB_RECT[2]), np.uint8)
    pgs = [(SUB_SHOW * FRAME_TICKS, build_display_set(
               SUB_SHOW * FRAME_TICKS, card, pal, SUB_RECT[0], SUB_RECT[1],
               screen=(W, H))),
           (SUB_CLEAR * FRAME_TICKS, build_display_set(
               SUB_CLEAR * FRAME_TICKS, card, pal, 0, 0, screen=(W, H),
               clear=True))]
    for i, au in enumerate(stream[:n]):
        pts = i * FRAME_TICKS
        w.write_sample(vi, au, pts_90k=pts, duration_90k=FRAME_TICKS,
                       sync=i == 0, annexb=True)
        for p, pkt in pgs:
            if pts <= p < pts + FRAME_TICKS:
                w.write_sample(pi, pkt, pts_90k=p)
        for start, dur, text in SUB_TEXT_CUES:
            if pts <= start * FRAME_TICKS < pts + FRAME_TICKS:
                w.write_sample(ti, text.encode(), pts_90k=start * FRAME_TICKS,
                               duration_90k=dur * FRAME_TICKS)
    w.finalize()


def card_colour():
    """(Y, Cb, Cr) of 9 (b)'s PGS card once decoded by the port's
    PgsDecoder and blended opaque by its blend on the CPU."""
    import torch
    from handbrake_tpu_torch.filters.rendersub import blend_rgba
    from handbrake_tpu_torch.subtitles.pgs import (PgsDecoder,
                                                   build_display_set)
    pal = np.zeros((256, 4), np.uint8)
    pal[1] = SUB_CARD_YCRCB + (255,)
    ev = [e for e in PgsDecoder().feed(build_display_set(
        0, np.ones((4, 4), np.uint8), pal, 0, 0, screen=(4, 4)), 0)
        if e.rgba is not None][0]
    planes = [torch.zeros((4, 4), dtype=torch.uint8),
              torch.zeros((2, 2), dtype=torch.uint8),
              torch.zeros((2, 2), dtype=torch.uint8)]
    out = blend_rgba(*planes, torch.from_numpy(ev.rgba), x0=0, y0=0, sw=2,
                     sh=2)
    return np.array([float(p[0, 0]) for p in out])


def read_sub_track(path):
    """(payload, duration) of each sample of an mp4's subtitle track."""
    from handbrake_tpu_torch.sources.mp4 import MP4Demuxer
    d = MP4Demuxer(path)
    try:
        si = [i for i, t in enumerate(d.tracks) if t.kind == "subtitle"]
        return [(bytes(d.read_sample(i, k).data),
                 d.read_sample(i, k).duration)
                for i in si for k in range(d.n_samples(i))]
    finally:
        d.close()


def phase_sub_job(tmp, label, stream):
    """9 (b): step 7's stream with a PGS and a text track through the
    CLI's default preset with ``-s 1,2 --subtitle-burned 1`` to mp4.
    Returns its numbers."""
    from handbrake_tpu_torch.cli.__main__ import main as cli_main
    from handbrake_tpu_torch.codecs.h264 import deblock_cuda
    from handbrake_tpu_torch.sources.mkv import MKVDemuxer
    from handbrake_tpu_torch.tools import profile_job as pj
    n = len(stream)
    src = os.path.join(tmp, "subs.mkv")
    sub_source(src, stream, n)
    argv = ["-e", "h264", "-q", "28", "--encoder-profile", "high"]
    sel = ["-s", "1,2", "--subtitle-burned", "1"]

    def job(source, out, *extra):
        with pj.JobSpy() as spy, pj.StageTimers() as st:
            reset_counts()
            rc = cli_main(["-i", source, "-o", out, *argv, *extra])
            launches = deblock_cuda.launches
        if rc != 0:
            raise RuntimeError(f"the subtitle job {extra} failed: exit {rc}")
        want = spy.p_frames() + spy.enc.n_redo
        if launches == 0 or launches != want:
            raise RuntimeError(f"the subtitle job {extra} did not launch "
                               f"deblock264 once per analysed P frame "
                               f"({launches}, {want})")
        return spy, dict(st.sec), launches

    out = os.path.join(tmp, "subs.mp4")
    spy, sec, launches = job(src, out, *sel)
    spy_n, _sec_n, _ = job(src, os.path.join(tmp, "nosubs.mp4"))
    ti, samples = read_mp4(out)
    # the same job on the CPU, on the source's first SUB_CPU_FRAMES frames
    src_cpu = os.path.join(tmp, "subs_cpu.mkv")
    sub_source(src_cpu, stream, SUB_CPU_FRAMES)
    out_cpu = os.path.join(tmp, "subs_cpu.mp4")
    t0 = time.perf_counter()
    if cli_main(["-i", src_cpu, "-o", out_cpu, *argv, *sel, "--device",
                 "cpu"]) != 0:
        raise RuntimeError("the CPU run of the subtitle job failed")
    t_cpu = time.perf_counter() - t0
    ti_cpu, samples_cpu = read_mp4(out_cpu)
    same = (ti_cpu.extradata == ti.extradata
            and samples_cpu == samples[:SUB_CPU_FRAMES])
    # the tx3g track: an empty lead-in, each cue, an empty gap between
    d = MKVDemuxer(src)
    try:
        cues = [(bytes(b.data), b.duration) for t, b in d.packets()
                if d.tracks[t].codec == "srt"]
    finally:
        d.close()
    tx3g = read_sub_track(out)
    texts = [(p[2:], dur) for p, dur in tx3g if p != b"\x00\x00"]
    tx3g_ok = (texts == cues and tx3g[0][0] == b"\x00\x00"
               and len(tx3g) == 2 * len(cues))
    # the burned card in the decoded frames, beside its colour as the
    # port's decoder and blend give it on the CPU
    frames, _ = decode_all(samples, ti.extradata)
    x, y, cw, ch = SUB_RECT
    want = card_colour()

    def rect_mean(f):
        return np.array([f[0][y + 8:y + ch - 8, x + 8:x + cw - 8].mean(),
                         f[1][(y + 8) // 2:(y + ch - 8) // 2,
                              (x + 8) // 2:(x + cw - 8) // 2].mean(),
                         f[2][(y + 8) // 2:(y + ch - 8) // 2,
                              (x + 8) // 2:(x + cw - 8) // 2].mean()])
    dist = [float(np.abs(rect_mean(f) - want).max()) for f in frames]
    shown = [i for i, dd in enumerate(dist) if dd < SUB_CARD_TOL]
    fps, fps_n = n / spy.seconds, n / spy_n.seconds
    share = sec.get("render_sub", 0.0) / max(sec.get("filter graph", 0.0),
                                             1e-9)
    print(f"subtitles 9 (b) ({label}): {W}x{H} H.264 mkv of {n} frames with "
          f"a PGS card (frames {SUB_SHOW}-{SUB_CLEAR - 1}) and a text track,"
          f" CLI default preset {' '.join(sel)} to mp4: {len(samples)} "
          f"samples; deblock264 launches {launches}; frames showing the "
          f"card's colour in its rectangle: {shown[0] if shown else None}-"
          f"{shown[-1] if shown else None} ({len(shown)}); the tx3g samples "
          f"equal the cues: {tx3g_ok} ({len(tx3g)} samples); the first "
          f"{SUB_CPU_FRAMES} samples equal the CPU run's byte for byte: "
          f"{same} ({t_cpu:.1f} s on the CPU); {fps:.2f} fps with -s, "
          f"{fps_n:.2f} without; render_sub {sec.get('render_sub', 0.0):.3f}"
          f" s of the filter graph's {sec.get('filter graph', 0.0):.3f} s "
          f"(host, {share:.3f})", flush=True)
    # the card shows for as many frames as its display sets span, none
    # before the first; it may start a frame late, as in the JAX package
    # (the CPU tests hold such a job's file equal to the reference's)
    run = shown and shown == list(range(shown[0], shown[-1] + 1))
    if len(samples) != n or not same or not tx3g_ok or not run or \
            len(shown) != SUB_CLEAR - SUB_SHOW or \
            shown[0] not in (SUB_SHOW, SUB_SHOW + 1):
        raise RuntimeError("the subtitle job's output is wrong")
    return {"fps": fps, "fps_without_subtitles": fps_n,
            "render_sub_s": sec.get("render_sub", 0.0),
            "filter_graph_s": sec.get("filter graph", 0.0),
            "render_sub_share": share, "launches": launches}


def phase_letterbox_srt(tmp, label):
    """9 (c): job (a)'s letterboxed source with an SRT burned in through
    the CLI's default preset: the stream equals the CPU run's, and the
    text is centred in the bottom fifth of the 1920x804 output.  Returns
    its numbers."""
    from handbrake_tpu_torch.cli.__main__ import main as cli_main
    from handbrake_tpu_torch.codecs.h264 import deblock_cuda
    from handbrake_tpu_torch.filters import resample_cuda
    from handbrake_tpu_torch.tools import profile_job as pj
    frames = pj.letterbox_frames(N_FRAMES)
    src = os.path.join(tmp, "lb.y4m")
    src_cpu = os.path.join(tmp, "lb_cpu.y4m")
    pj.write_letterbox(src, frames)
    pj.write_letterbox(src_cpu, frames[:N_CPU])
    del frames
    srt = os.path.join(tmp, "lb.srt")
    with open(srt, "w", encoding="utf-8") as f:
        f.write(f"1\n00:00:00,000 --> 00:00:05,000\n{SUB_CUE}\n\n")
    burn = ["--srt-file", srt, "--srt-burn", "1"]
    out = os.path.join(tmp, "lb.mp4")
    with pj.JobSpy() as spy, pj.StageTimers() as st:
        reset_counts()
        rc = cli_main(pj.letterbox_argv(src, out) + burn)
        rs_launches = resample_cuda.launches
        launches = deblock_cuda.launches
    if rc != 0 or rs_launches != N_FRAMES or launches == 0 or \
            launches != spy.p_frames() + spy.enc.n_redo:
        raise RuntimeError(f"the letterbox job with subtitles failed or "
                           f"missed a kernel (exit {rc}, {rs_launches} "
                           f"resample launches, {launches} deblock264)")
    ti, samples = read_mp4(out)
    outs = {}
    for name, extra in (("cpu", burn + ["--device", "cpu"]), ("plain", [])):
        outs[name] = os.path.join(tmp, f"lb_{name}.mp4")
        if cli_main(pj.letterbox_argv(src_cpu, outs[name]) + extra) != 0:
            raise RuntimeError(f"the letterbox job ({name}) failed")
    ti_cpu, samples_cpu = read_mp4(outs["cpu"])
    same = (ti_cpu.extradata == ti.extradata
            and samples_cpu == samples[:N_CPU])
    ti_p, plain = read_mp4(outs["plain"])
    # the last frame of the CPU run (the cue starts at 0 but shows from a
    # frame later, as in the JAX package)
    k = N_CPU - 1
    f_sub = decode_all(samples[:N_CPU], ti.extradata)[0][k][0].astype(
        np.int32)
    f_plain = decode_all(plain, ti_p.extradata)[0][k][0].astype(np.int32)
    rows, cols = np.nonzero(np.abs(f_sub - f_plain) > 40)
    oh, ow = f_sub.shape
    box = ([int(rows.min()), int(rows.max()), int(cols.min()),
            int(cols.max())] if rows.size else None)
    centred = box is not None and abs((box[2] + box[3]) / 2 - ow / 2) \
        <= ow * 0.02
    bottom = box is not None and (box[0] + box[1]) / 2 >= oh * 0.8
    print(f"subtitles 9 (c) ({label}): job (a)'s source with --srt-file "
          f"--srt-burn 1: {len(samples)} samples at {ti.width}x{ti.height}; "
          f"the first {N_CPU} equal the CPU run's byte for byte: {same}; the "
          f"burned text's box in decoded frame {k}, rows/columns "
          f"{box}: horizontally centred {centred}, in the bottom fifth "
          f"{bottom}; {N_FRAMES / spy.seconds:.2f} fps; host s of the job's "
          f"stages: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                  sorted(st.sec.items())), flush=True)
    if (ti.width, ti.height) != JOB_OUT or len(samples) != N_FRAMES or \
            not same or not centred or not bottom:
        raise RuntimeError("the letterbox job's burned subtitle is wrong")
    return {"fps": N_FRAMES / spy.seconds, "box": box,
            "launches": launches, "resample_launches": rs_launches,
            "stage_s": dict(st.sec)}


def phase_subtitles(tmp, label, stream):
    """9: the blend alone, then the two subtitle jobs."""
    blend = phase_blend(label)
    job_b = phase_sub_job(tmp, label, stream)
    job_c = phase_letterbox_srt(tmp, label)
    return {"blend": blend, "job": job_b, "letterbox": job_c}


class BFrameSpy:
    """Records what a B-frame job builds and does, by wrapping the port's
    work module and the walker for one drive: the job, the encoder
    adapter, the planes the adapter is given, each frame's
    reconstruction before the adapter drops it, the decode order,
    do_job's wall time, the card's time under torch.profiler over that
    same span, and the walker's host seconds per I, P and B frame."""

    def __init__(self):
        self.job = self.adapter = self.prof = None
        self.planes, self.recons, self.order = [], {}, []
        self.sec = {"I": [], "P": [], "B": []}
        self.seconds = 0.0

    def _timed(self, fn, kind):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.sec[kind].append(time.perf_counter() - t0)
        return call

    def __enter__(self):
        from handbrake_tpu_torch import work
        from handbrake_tpu_torch.codecs.h264.encoder_b import H264BEncoder
        walker = (("I", "_encode_idr"), ("P", "_encode_p"),
                  ("B", "_encode_b"))
        self._orig = [(work, n, getattr(work, n))
                      for n in ("create_video_encoder", "do_job")]
        self._orig += [(H264BEncoder, n, getattr(H264BEncoder, n))
                       for _k, n in walker]
        make_enc, run_job = work.create_video_encoder, work.do_job

        def create_video_encoder(job, *a, **k):
            self.job = job
            ad = self.adapter = make_enc(job, *a, **k)
            push, release = ad.push_display_frame, ad._release

            def push_display_frame(y, u, v):
                self.planes.append((np.array(y), np.array(u), np.array(v)))
                return push(y, u, v)

            def _release(aus):
                for d, _au in aus:
                    self.recons[d] = ad.benc.recons[d]
                    self.order.append(d)
                return release(aus)

            ad.push_display_frame, ad._release = push_display_frame, _release
            return ad

        def do_job(*a, **k):
            import torch
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as self.prof:
                t0 = time.perf_counter()
                try:
                    return run_job(*a, **k)
                finally:
                    torch.cuda.synchronize()
                    self.seconds = time.perf_counter() - t0

        work.create_video_encoder, work.do_job = create_video_encoder, do_job
        for kind, name in walker:
            setattr(H264BEncoder, name,
                    self._timed(getattr(H264BEncoder, name), kind))
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self._orig:
            setattr(obj, name, fn)


def read_mp4_order(path):
    """(track info, annex-B samples in decode order, cts offsets)."""
    from handbrake_tpu_torch.sources.mp4 import MP4Demuxer
    d = MP4Demuxer(path)
    try:
        n = d.n_samples(0)
        return (d.tracks[0], [bytes(d.read_sample(0, i).data)
                              for i in range(n)],
                list(d._samples[0].cts_offsets))
    finally:
        d.close()


def decodes_to(stream, recons) -> bool:
    """The port's decoder gives back `recons` (display index → the
    walker's MB-aligned planes), in display order, cropped as coded."""
    from handbrake_tpu_torch.codecs.h264.native_decoder import (
        NativeH264Decoder)
    got = NativeH264Decoder().decode(stream)
    return len(got) == len(recons) and all(
        np.array_equal(g, r[:g.shape[0], :g.shape[1]])
        for d, planes in enumerate(got) for g, r in zip(planes, recons[d]))


@contextlib.contextmanager
def log_lines():
    """The port's log lines written inside the block (each still printed
    to stderr)."""
    from handbrake_tpu_torch.utils import logging as hblog
    lines = []

    def keep(line):
        lines.append(line)
        print(line, file=sys.stderr, flush=True)
    hblog.register_logger(keep)
    try:
        yield lines
    finally:
        hblog.register_logger(None)


def phase_noise(label):
    """10 (c): the noise frames through H264BEncoder(bframes=3) complete
    and decode to its reconstructions."""
    from handbrake_tpu_torch.codecs.h264.encoder import EncoderConfig
    from handbrake_tpu_torch.codecs.h264.encoder_b import H264BEncoder
    rng = np.random.default_rng(NOISE_SEED)
    frames = [tuple(rng.integers(0, 256, shape, dtype=np.uint8)
                    for shape in ((NOISE_H, NOISE_W),) + 2 * (
                        (NOISE_H // 2, NOISE_W // 2),))
              for _ in range(NOISE_N)]
    enc = H264BEncoder(EncoderConfig(width=NOISE_W, height=NOISE_H),
                       bframes=3)
    t0 = time.perf_counter()
    aus = []
    for f in frames:
        aus += enc.push_frame(*f)
    aus += enc.flush()
    sec = time.perf_counter() - t0
    same = decodes_to(b"".join(au for _d, au in aus), enc.recons)
    print(f"bframes (c): {NOISE_N} random-noise {NOISE_W}x{NOISE_H} frames "
          f"(seed {NOISE_SEED}, on which the JAX package's walker raises) "
          f"through H264BEncoder(bframes=3): {len(aus)} access units in "
          f"{sec:.2f} s of host time ({label}); decoded equal to its "
          f"reconstructions: {same}", flush=True)
    if len(aus) != NOISE_N or not same:
        raise RuntimeError("the noise frames did not encode and decode "
                           "exactly")
    return {"access_units": len(aus), "host_s": sec}


def phase_bframes(tmp, label):
    """10: the letterboxed source's first B_N frames through the CLI with
    --bframes, its checks, the same job without B-frames, and the noise
    frames.  Returns the numbers."""
    import torch
    from handbrake_tpu_torch.cli.__main__ import main as cli_main
    from handbrake_tpu_torch.codecs.h264 import deblock_cuda
    from handbrake_tpu_torch.filters import resample_cuda
    from handbrake_tpu_torch.job import schema as S
    from handbrake_tpu_torch.tools import profile_job as pj
    frames = pj.letterbox_frames(B_N)
    src = os.path.join(tmp, "bframes.y4m")
    pj.write_letterbox(src, frames)
    out, out_p = (os.path.join(tmp, f) for f in ("bframes.mp4",
                                                 "bframes_none.mp4"))
    argv = ["-i", src, "-e", "h264", "-q", str(B_Q)]
    with BFrameSpy() as spy, log_lines() as lines:
        reset_counts()
        t0 = time.perf_counter()
        rc = cli_main(argv + ["-o", out, "--bframes", str(B_FRAMES)])
        torch.cuda.synchronize()
        t_cli = time.perf_counter() - t0
        rs_launches = resample_cuda.launches
        db_launches = deblock_cuda.launches
    if rc != 0:
        raise RuntimeError(f"the B-frame CLI job failed with exit code {rc}")
    said = [ln for ln in lines if B_LOG in ln]
    print(f"bframes (a): the job's log says {B_LOG!r}: "
          f"{said[0] if said else 'NOT LOGGED'}", flush=True)
    if len(said) != 1:
        raise RuntimeError(f"the B-frame job logged {len(said)} lines that "
                           f"say {B_LOG!r}, not 1")
    device_ms = sum(e.self_device_time_total
                    for e in spy.prof.key_averages()) / 1e3
    busy = device_ms / (spy.seconds * 1e3)
    ti, samples, cts = read_mp4_order(out)
    size = (ti.width, ti.height)
    walker_ms = {k: 1e3 * statistics.mean(v) for k, v in spy.sec.items()
                 if v}
    n_kind = {k: len(v) for k, v in spy.sec.items()}
    print(f"bframes (a): {pj.JOB_W}x{pj.JOB_H} letterboxed y4m, first {B_N} "
          f"frames, CLI -e h264 -q {B_Q} --bframes {B_FRAMES}, preset Fast "
          f"1080p30: mp4 {len(samples)} samples at {size[0]}x{size[1]}; "
          f"decode order {spy.order}; cts offsets {cts}; frames I/P/B "
          f"{n_kind['I']}/{n_kind['P']}/{n_kind['B']}; resample launches "
          f"{rs_launches}, deblock264 launches {db_launches}", flush=True)
    if len(samples) != B_N or size != JOB_OUT:
        raise RuntimeError(f"the B-frame mp4 holds {len(samples)} samples "
                           f"at {size}, not {B_N} at {JOB_OUT}")
    if spy.order == sorted(spy.order) or not any(cts):
        raise RuntimeError("the B-frame job's decode order is its display "
                           "order")
    if n_kind != {"I": 1, "P": B_GROUPS, "B": B_GROUPS * B_FRAMES}:
        raise RuntimeError(f"the walker coded {n_kind}, not an IDR and "
                           f"{B_GROUPS} group(s) of P + {B_FRAMES} B")
    if rs_launches != B_N:
        raise RuntimeError("the B-frame job did not launch the resample "
                           "kernel once a frame")
    stream = avcc_parameter_sets(ti.extradata) + b"".join(samples)
    same_recon = decodes_to(stream, spy.recons)
    print(f"bframes (b): the mp4 decoded by the port's decoder equals the "
          f"walker's reconstructions, frame for frame in display order: "
          f"{same_recon}", flush=True)
    if not same_recon:
        raise RuntimeError("the B-frame stream does not decode to the "
                           "walker's reconstructions")
    cs = next(f.settings for f in spy.job.filters
              if f.id == S.FILTER_CROP_SCALE)
    f = crop_scale_filter(cs, "cpu")
    t0 = time.perf_counter()
    same_planes = len(spy.planes) == B_N and all(
        np.array_equal(host(p), q) for k in range(B_N)
        for p, q in zip(scale(f, with_bars(frames[k])), spy.planes[k]))
    t_cpu = time.perf_counter() - t0
    print(f"bframes (b): the planes the encoder received equal the port's "
          f"CropScaleFilter on the CPU for the same {B_N} source frames: "
          f"{same_planes} ({t_cpu:.1f} s on the CPU)", flush=True)
    if not same_planes:
        raise RuntimeError("the B-frame job's scaled planes differ from the "
                           "CPU's")
    rc = cli_main(argv + ["-o", out_p])
    if rc != 0:
        raise RuntimeError(f"the job without B-frames failed ({rc})")
    _ti, samples_p, _cts = read_mp4_order(out_p)
    nbytes, nbytes_p = sum(map(len, samples)), sum(map(len, samples_p))
    noise = phase_noise(label)
    rec = {"seconds": spy.seconds, "fps": B_N / spy.seconds,
           "cli_s": t_cli, "walker_ms": walker_ms, "log_line": said[0],
           "stream_bytes": nbytes, "stream_bytes_no_bframes": nbytes_p,
           "device_ms": device_ms, "busy_share": busy,
           "resample_launches": rs_launches, "noise": noise}
    print(f"bframes (d) ({label}): do_job {spy.seconds:.2f} s, "
          f"{rec['fps']:.3f} fps ({B_N} frames, under torch.profiler); CLI "
          f"in all (scan + job) {t_cli:.2f} s; the walker's host ms a frame "
          + ", ".join(f"{k} {v:.1f}" for k, v in walker_ms.items())
          + f"; stream {nbytes} B, {nbytes_p} B without --bframes (the "
          f"device path; both CAVLC, that one deblocked in the loop); the "
          f"card busy {device_ms:.1f} ms of "
          f"{spy.seconds * 1e3:.1f} ms, share {busy:.4f}", flush=True)
    return rec


@contextlib.contextmanager
def kept_journal():
    """Within it, a checkpointed job keeps its journal at the end, as a
    kill would leave it (the finished output file stays)."""
    from handbrake_tpu_torch import checkpoint
    orig = checkpoint.CkptJournal.close
    checkpoint.CkptJournal.close = lambda self, complete=False: self.f.close()
    try:
        yield
    finally:
        checkpoint.CkptJournal.close = orig


def same_frames(a, b) -> bool:
    return len(a) == len(b) and all(
        np.array_equal(p, q) for fa, fb in zip(a, b) for p, q in zip(fa, fb))


def file_bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def phase_decoder_threads(tmp, label, stream):
    """11 (a): DEC_THREADS threads decode phase 7's stream at once, and two
    do_job calls on threads over H.264 sources equal the serial runs."""
    import threading

    from handbrake_tpu_torch import work
    from handbrake_tpu_torch.codecs.h264.native_decoder import (
        NativeH264Decoder)
    from handbrake_tpu_torch.tools import profile_job as pj
    whole = b"".join(stream)
    t0 = time.perf_counter()
    serial = NativeH264Decoder().decode(whole)
    t_serial = time.perf_counter() - t0
    start = threading.Barrier(DEC_THREADS)

    def decode(_k):
        start.wait()
        return NativeH264Decoder().decode(whole)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(DEC_THREADS) as pool:
        got = list(pool.map(decode, range(DEC_THREADS)))
    t_threads = time.perf_counter() - t0
    differ = sum(1 for g in got if not same_frames(g, serial))
    # two jobs on threads: phase 7's mp4 source and its mkv output
    srcs = [os.path.join(tmp, "src.mp4"), os.path.join(tmp, "out.mkv")]

    def job(k, tag):
        out = os.path.join(tmp, f"threads_{tag}{k}.mp4")
        j = pj.unscaled_job(srcs[k], out)
        j.range.type, j.range.start, j.range.end = "frame", 1, THREAD_JOB_N
        work.do_job(j)
        return file_bytes(out)
    serial_files = [job(k, "serial") for k in range(2)]
    with ThreadPoolExecutor(2) as pool:
        threaded_files = list(pool.map(lambda k: job(k, "thread"), range(2)))
    same_jobs = threaded_files == serial_files
    rec = {"phase": "11a", "card": label, "threads": DEC_THREADS,
           "frames": len(serial), "decodes": len(got),
           "differing_decodes": differ, "serial_decode_s": t_serial,
           "threaded_decodes_s": t_threads, "jobs_equal_serial": same_jobs}
    print(json.dumps(rec), flush=True)
    if len(serial) != SRC_N or differ != 0:
        raise RuntimeError(f"{differ} of {len(got)} threaded decodes differ "
                           "from the serial decode")
    if not same_jobs:
        raise RuntimeError("do_job on two threads differs from the serial "
                           "runs")
    return rec


def phase_resume(tmp, label):
    """11 (b): the unscaled 1080p job with --checkpoint, its journal cut
    after the RESUME_CUT-th GOP marker and resumed; the resumed file must
    equal the uninterrupted one."""
    import torch

    from handbrake_tpu_torch import checkpoint, work
    from handbrake_tpu_torch.codecs.h264 import deblock_cuda
    from handbrake_tpu_torch.tools import profile_job as pj
    from handbrake_tpu_torch.utils.synth import make_clip, write_y4m
    src = os.path.join(tmp, "resume.y4m")
    out = os.path.join(tmp, "resume.mp4")
    write_y4m(src, make_clip(W, H, N_FRAMES, seed=21), W, H)

    def job(**kw):
        j = pj.unscaled_job(src, out)
        j.encoder_options = f"keyint={RESUME_KEYINT}"
        for k, v in kw.items():
            setattr(j, k, v)
        return j
    with kept_journal():
        reset_counts()
        t0 = time.perf_counter()
        work.do_job(job(checkpoint=True))
        torch.cuda.synchronize()
        t_full = time.perf_counter() - t0
        launches_full = deblock_cuda.launches
    full = file_bytes(out)
    data = file_bytes(out + ".ckpt")
    marks = [end for tag, _s, end in checkpoint.spans(data) if tag == "g"]
    with open(out + ".ckpt", "wb") as f:
        f.write(data[:marks[RESUME_CUT - 1]])
    os.unlink(out)
    reset_counts()
    t0 = time.perf_counter()
    stats = work.do_job(job(resume=True))
    torch.cuda.synchronize()
    t_resume = time.perf_counter() - t0
    launches = deblock_cuda.launches
    done = RESUME_CUT * RESUME_KEYINT
    p_after = sum(1 for i in range(done, N_FRAMES) if i % RESUME_KEYINT)
    equal = file_bytes(out) == full
    rec = {"phase": "11b", "card": label, "frames": N_FRAMES,
           "keyint": RESUME_KEYINT, "resumed_at_frame": done + 1,
           "frames_coded_on_resume": stats["frames_out"],
           "equal_to_uninterrupted": equal, "full_s": t_full,
           "resume_s": t_resume, "deblock264_launches_full": launches_full,
           "deblock264_launches_resume": launches,
           "p_frames_after_resume_point": p_after,
           "journal_left": os.path.exists(out + ".ckpt")}
    print(json.dumps(rec), flush=True)
    if not equal or rec["journal_left"]:
        raise RuntimeError("the resumed 1080p file differs from the "
                           "uninterrupted one")
    if launches < p_after:
        raise RuntimeError("the resumed job did not run deblock264 for each "
                           "P frame after the resume point")
    return rec


class GopSpy:
    """Records each call of parallel/gop.encode_gop_parallel (its frames,
    geometry, qp and G, and its result) while a job runs."""

    def __enter__(self):
        from handbrake_tpu_torch.parallel import gop
        self.calls = []
        self._gop, self._orig = gop, gop.encode_gop_parallel

        def spy(frames, width, height, qp, n_gops, fps=(30000, 1001),
                device=None, mesh=None, sar=(1, 1)):
            res = self._orig(frames, width, height, qp, n_gops, fps, device,
                             mesh, sar)
            self.calls.append((list(frames), width, height, qp, n_gops, fps,
                               res))
            return res
        gop.encode_gop_parallel = spy
        return self

    def __exit__(self, *exc):
        self._gop.encode_gop_parallel = self._orig


def phase_gop_parallel(tmp, label):
    """11 (c): job (a)'s letterboxed source with --gop-parallel GP_N; each
    GOP equals its chunk encoded serially on the card by its own encoder;
    GP_CPU_FRAMES frames cut to GP_CPU_GOPS GOPs equal the CPU's; the
    two-pass rate run; fps and busy share beside the serial job."""
    from handbrake_tpu_torch.cli.__main__ import main as cli_main
    from handbrake_tpu_torch.codecs.h264.encoder import (EncoderConfig,
                                                         H264Encoder)
    from handbrake_tpu_torch.filters import resample_cuda
    from handbrake_tpu_torch.mux.nal import strip_parameter_sets
    from handbrake_tpu_torch.parallel import gop
    from handbrake_tpu_torch.tools import profile_job as pj
    src = os.path.join(tmp, "gp.y4m")
    pj.write_letterbox(src, pj.letterbox_frames(N_FRAMES))
    out = os.path.join(tmp, "gp.mp4")
    argv = pj.letterbox_argv(src, out) + ["--gop-parallel", str(GP_N)]
    with GopSpy() as spy:
        reset_counts()
        dev_ms, wall_ms = pj._busy_ms(lambda: cli_main(argv))
        rs_launches = resample_cuda.launches
    if len(spy.calls) != 1:
        raise RuntimeError(f"{len(spy.calls)} GOP-parallel windows, "
                           "expected 1")
    frames, w, h, qp, G, fps, (streams, _full, frame_aus) = spy.calls[0]
    ti, samples = read_mp4(out)
    want = [au for aus in frame_aus for au in aus]
    muxed = len(samples) == N_FRAMES and all(
        strip_parameter_sets(a) == s for a, s in zip(want, samples))
    chunks = gop.split_gops(N_FRAMES, G)
    serial_equal = []
    for (s, ln), got in zip(chunks, streams):
        enc = H264Encoder(EncoderConfig(width=w, height=h, qp=qp, gop=ln,
                                        fps=fps))
        serial_equal.append(got == b"".join(enc.encode_frame(*frames[i])
                                            for i in range(s, s + ln)))
    cut = frames[:GP_CPU_FRAMES]
    t0 = time.perf_counter()
    card_cut = gop.encode_gop_parallel(cut, w, h, qp, GP_CPU_GOPS, fps)[0]
    cpu_cut = gop.encode_gop_parallel(cut, w, h, qp, GP_CPU_GOPS, fps,
                                      device="cpu")[0]
    t_cut = time.perf_counter() - t0
    # the same job without --gop-parallel
    out_serial = os.path.join(tmp, "gp_serial.mp4")
    dev_ms_s, wall_ms_s = pj._busy_ms(
        lambda: cli_main(pj.letterbox_argv(src, out_serial)))
    # two passes to a bitrate
    out_rate = os.path.join(tmp, "gp_rate.mp4")
    t0 = time.perf_counter()
    rc = cli_main(pj.letterbox_argv(src, out_rate)
                  + ["--gop-parallel", str(GP_N), "-b", str(GP_KBPS),
                     "--two-pass"])
    t_rate = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"the two-pass GOP-parallel job failed ({rc})")
    _ti, rate_samples = read_mp4(out_rate)
    secs = N_FRAMES * FRAME_TICKS / 90000
    rec = {"phase": "11c", "card": label, "gop_parallel": GP_N, "gops": G,
           "chunks": chunks, "qp": qp, "size": [w, h],
           "samples": len(samples), "muxed_equal_frame_aus": muxed,
           "resample_launches": rs_launches,
           "gops_equal_serial_encoders": serial_equal,
           "cut_frames": GP_CPU_FRAMES, "cut_gops": GP_CPU_GOPS,
           "cut_equal_cpu": card_cut == cpu_cut, "cut_s": t_cut,
           "fps": N_FRAMES / (wall_ms / 1e3), "device_ms": dev_ms,
           "busy_share": dev_ms / wall_ms,
           "serial_fps": N_FRAMES / (wall_ms_s / 1e3),
           "serial_device_ms": dev_ms_s,
           "serial_busy_share": dev_ms_s / wall_ms_s,
           "two_pass_target_kbps": GP_KBPS,
           "two_pass_achieved_kbps": sum(map(len, rate_samples)) * 8
           / secs / 1e3, "two_pass_samples": len(rate_samples),
           "two_pass_cli_s": t_rate}
    print(json.dumps(rec), flush=True)
    if not muxed or not all(serial_equal) or len(serial_equal) != GP_N:
        raise RuntimeError("the GOP-parallel job's GOPs differ from their "
                           "chunks encoded serially")
    if card_cut != cpu_cut:
        raise RuntimeError("the GOP-parallel cut differs between the card "
                           "and the CPU")
    if len(rate_samples) != N_FRAMES:
        raise RuntimeError("the two-pass GOP-parallel job lacks samples")
    if rs_launches != N_FRAMES:
        raise RuntimeError("the GOP-parallel job did not launch the resample "
                           "kernel once a frame")
    return rec


def phase_tiles(label):
    """11 (d): nlmeans with tile_parallel TILES (one card runs it untiled)
    on a 1080p 4:2:0 frame (its temporal reference the frame before)
    equals the filter without it on the card bit for bit; ms of each, timed in turns (untiled, the
    tiled ones, then back in reverse) and averaged per variant."""
    import torch

    from handbrake_tpu_torch.core.buffer import PIX_FMTS, Buffer, Geometry
    from handbrake_tpu_torch.filters import base
    from handbrake_tpu_torch.job import schema as S
    from handbrake_tpu_torch.utils.synth import make_clip
    clip = make_clip(W, H, 2, seed=17)
    planes = [[torch.from_numpy(p).cuda() for p in f] for f in clip]
    variants = (0,) + TILES
    filters, outs = {}, {}
    for tp in variants:
        f = base.create_filter(S.FILTER_NLMEANS, {"tile_parallel": tp})
        f.init(base.FilterInit(geometry=Geometry(W, H), device="cuda",
                               pix_fmt=PIX_FMTS["yuv420p"]))
        filters[tp], outs[tp] = f, []
        for k, p in enumerate(planes):
            outs[tp] += f.work(Buffer(planes=list(p),
                                      pix_fmt=PIX_FMTS["yuv420p"],
                                      pts=k))[0].planes
    turns = {tp: [] for tp in variants}
    for tp in variants + variants[::-1]:
        turns[tp].append(cuda_ms(lambda: filters[tp].work(Buffer(
            planes=list(planes[1]), pix_fmt=PIX_FMTS["yuv420p"], pts=1)),
            NL_REPS))
    equal = {tp: all(torch.equal(a, b) for a, b in zip(outs[tp], outs[0]))
             for tp in TILES}
    rec = {"phase": "11d", "card": label, "size": [W, H],
           "equal_untiled": {str(k): v for k, v in equal.items()},
           "ms": {str(k): statistics.mean(v) for k, v in turns.items()},
           "ms_turns": {str(k): v for k, v in turns.items()}}
    print(json.dumps(rec), flush=True)
    if not all(equal.values()):
        raise RuntimeError("tiled nlmeans differs from the untiled filter")
    return rec


def phase_controller(tmp, label, stream):
    """11 (e): two WorkerServers on the card in this process and a
    Controller over them: phase 7's stream with a PCM track, to mkv with
    AAC; every frame and the audio present, and each worker's segment
    equal to a do_job of its range on the card."""
    from handbrake_tpu_torch import work
    from handbrake_tpu_torch.job.schema import Job
    from handbrake_tpu_torch.mux.mkv import MKVWriter
    from handbrake_tpu_torch.parallel.controller import (Controller,
                                                         WorkerServer)
    from handbrake_tpu_torch.parallel.gop import split_gops
    from handbrake_tpu_torch.sources.mkv import MKVDemuxer
    src = os.path.join(tmp, "ctl_src.mkv")
    w = MKVWriter(src)
    vi = w.add_video_track(codec="h264", width=W, height=H, fps=30000 / 1001)
    ai = w.add_audio_track(codec="pcm_s16le", sample_rate=48000, channels=2)
    per = 1600
    pcm = tone(48000, 2, per * len(stream), 5)
    pcm = np.clip(pcm * 32767, -32768, 32767).astype("<i2")
    for i, au in enumerate(stream):
        w.write_sample(vi, au, pts_90k=i * FRAME_TICKS,
                       duration_90k=FRAME_TICKS, sync=i == 0, annexb=True)
        w.write_sample(ai, pcm[i * per:(i + 1) * per].tobytes(),
                       pts_90k=i * FRAME_TICKS, duration_90k=FRAME_TICKS)
    w.finalize()
    out = os.path.join(tmp, "ctl.mkv")
    job_json = {"Source": {"Path": src},
                "Destination": {"Mux": "mkv", "File": out},
                "Video": {"Encoder": "h264", "Quality": 28.0,
                          "Profile": "high"},
                "Audio": {"AudioList": [{"Track": 1, "Encoder": "aac",
                                         "Mixdown": "stereo",
                                         "Bitrate": 128}]}}
    segments = []

    class Capture(Controller):
        def _mux_segments(self, segs, dest):
            segments.extend(segs)
            Controller._mux_segments(segs, dest)
    workers = [WorkerServer(token="chip").start() for _ in range(2)]
    try:
        t0 = time.perf_counter()
        res = Capture([("127.0.0.1", s.port) for s in workers],
                      token="chip").run(job_json, n_frames=len(stream))
        t_run = time.perf_counter() - t0
    finally:
        for s in workers:
            s.stop()
    if res.get("error"):
        raise RuntimeError(f"the controller failed: {res['error']}")
    seg_equal = []
    for k, (s, ln) in enumerate(split_gops(len(stream), 2)):
        j = Job.from_json(job_json)
        j.range.type, j.range.start, j.range.end = "frame", s + 1, s + ln
        j.file, j.mux = os.path.join(tmp, f"ctl_seg{k}.mp4"), "mp4"
        work.do_job(j)
        seg_equal.append(file_bytes(j.file) == segments[k])
    d = MKVDemuxer(out)
    kinds = [t.kind for t in d.tracks]
    counts = {}
    for trk, _p in d.packets():
        counts[trk] = counts.get(trk, 0) + 1
    codecs = [t.codec for t in d.tracks]
    d.close()
    n_video = counts.get(kinds.index("video"), 0) if "video" in kinds else 0
    n_audio = counts.get(kinds.index("audio"), 0) if "audio" in kinds else 0
    rec = {"phase": "11e", "card": label, "frames_out": res["frames_out"],
           "per_host": res["per_host"], "tracks": kinds, "codecs": codecs,
           "video_packets": n_video, "audio_packets": n_audio,
           "segments_equal_do_job": seg_equal, "run_s": t_run}
    print(json.dumps(rec), flush=True)
    if n_video != len(stream) or "aac" not in codecs or n_audio == 0:
        raise RuntimeError("the controller's mkv lacks frames or its audio")
    if not all(seg_equal):
        raise RuntimeError("a worker's segment differs from a do_job of its "
                           "range")
    return rec


def phase_scale_out(tmp, label, stream):
    """11: decoder threads, resume, GOP-parallel, tiles and the
    controller on the card.  Returns their numbers."""
    t0 = time.perf_counter()
    rec = {"decoder_threads": phase_decoder_threads(tmp, label, stream),
           "resume": phase_resume(tmp, label),
           "gop_parallel": phase_gop_parallel(tmp, label),
           "tiles": phase_tiles(label),
           "controller": phase_controller(tmp, label, stream)}
    rec["seconds"] = time.perf_counter() - t0
    print(f"phase 11 ({label}): {rec['seconds']:.1f} s", flush=True)
    return rec


def disc_tone(ch, seconds, seed):
    return tone(48000, ch, int(round(48000 * seconds)), seed)


def dvd_folder(root, n_pictures=None):
    """12 (a): a VIDEO_TS folder over two VOBs holding the 720x480 MPEG-2
    fixture (its first n_pictures in stream order, or all), an AC-3 2.0
    track and a 16-bit DVD LPCM track from the port's encoders (as long
    as the video), a white VobSub card on stream 0x20 shown from display
    frame DVD_CARD_AT on, and IFOs with a palette and two chapters.
    Returns (folder, the AC-3 frames, pictures)."""
    from handbrake_tpu_torch.audio.ac3enc import Ac3Encoder
    from handbrake_tpu_torch.subtitles.vobsub import build_spu
    from handbrake_tpu_torch.tools import source_builders as B
    es = B.fixture("mpeg2_720x480.m2v")
    if n_pictures:
        es = b"".join(B.split_pictures(es)[:n_pictures])
    units = B.video_units(es, DVD_T0, FRAME_TICKS)
    n = len(units)
    secs = n * FRAME_TICKS / 90000
    ac3 = Ac3Encoder(48000, 2, 192000)
    frames = ac3.encode(disc_tone(2, secs, 21)) + ac3.flush()
    units += [(DVD_T0 + k * 2880, 0xBD, f, B.ac3_sub, DVD_T0 + k * 2880)
              for k, f in enumerate(frames)]
    lp = disc_tone(2, secs, 22)
    units += [(DVD_T0 + k * 900, 0xBD,
               B.s16be_lpcm(lp[k * 480:(k + 1) * 480]), B.lpcm_sub,
               DVD_T0 + k * 900) for k in range(len(lp) // 480)]
    x, y, w, h = DVD_CARD
    spu = build_spu(np.ones((h, w), np.uint8), x=x, y=y,
                    stop_delay=(n * FRAME_TICKS) // 1024)
    at = DVD_T0 + DVD_CARD_AT * FRAME_TICKS
    units.append((at, 0xBD, spu, B.spu_sub, at))
    half = n * FRAME_TICKS / 90000 / 2
    B.write_dvd(root, B.build_ps(units), 2, [half, half])
    return root, frames, n


def device_busy_ms(prof) -> float:
    """The card's busy ms in a finished profile: its device events'
    (kernels, copies, sets) durations summed from the raw trace.
    ``key_averages`` gives the same sum, but building it takes ~20 s for
    a job of a few thousand launches."""
    import torch
    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation()) / 1e6


def disc_job(run, argv_or_job, device=None, keep=0, cross_check=False):
    """One job (through the CLI or work.do_job) on the card under the
    profiler, its launches read after, or on the CPU without it: (do_job
    s, the card's busy ms in it, deblock264 and resample launches, the
    JobSpy keeping the first `keep` frames' planes).  The profiler traces
    the card alone (CUPTI).  With cross_check, the busy ms must equal
    ``key_averages``' sum of device time."""
    import torch
    from handbrake_tpu_torch.cli.__main__ import main as cli_main
    from handbrake_tpu_torch.codecs.h264 import deblock_cuda
    from handbrake_tpu_torch.filters import resample_cuda
    from handbrake_tpu_torch.tools import profile_job as pj
    from handbrake_tpu_torch import work

    def go():
        if run == "cli":
            rc = cli_main(argv_or_job)
            if rc != 0:
                raise RuntimeError(f"phase 12: the CLI job exited {rc}")
        else:
            work.do_job(argv_or_job, device=device)

    with pj.JobSpy(keep) as spy:
        if device == "cpu":
            go()
            return spy.seconds, 0.0, 0, 0, spy
        reset_counts()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            go()
            torch.cuda.synchronize()
        dev_ms = device_busy_ms(prof)
        if dev_ms <= 0:
            raise RuntimeError("phase 12: the profiler saw no device time")
        if cross_check:
            ka_ms = sum(e.self_device_time_total
                        for e in prof.key_averages()) / 1e3
            print(f"phase 12: the card busy {dev_ms:.3f} ms from the raw "
                  f"trace, {ka_ms:.3f} ms by key_averages", flush=True)
            if abs(dev_ms - ka_ms) > 0.01 * ka_ms + 0.01:
                raise RuntimeError("phase 12: the raw trace's device time "
                                   "differs from key_averages'")
        return (spy.seconds, dev_ms, deblock_cuda.launches,
                resample_cuda.launches, spy)


def luma_means(path, rect):
    """The mean luma of `rect` (x, y, w, h) in each decoded frame of an
    mp4's video track, in display order."""
    from handbrake_tpu_torch.codecs.registry import create_video_decoder
    from handbrake_tpu_torch.sources.mp4 import MP4Demuxer
    d = MP4Demuxer(path)
    dec = create_video_decoder("h264", d.tracks[0].extradata)
    frames = []
    for i in range(d.n_samples(0)):
        frames += dec.feed(d.read_sample(0, i))
    frames += dec.flush()
    d.close()
    x, y, w, h = rect
    return [float(np.asarray(f.planes[0])[y:y + h, x:x + w].mean())
            for f in frames]


def phase_dvd(tmp, label):
    """12 (a): the DVD folder through the CLI's default preset and device
    with --decomb -m, the card burned, AC-3 copied, LPCM to AAC."""
    from handbrake_tpu_torch.job import schema as S
    root, ac3_frames, n = dvd_folder(os.path.join(tmp, "dvd"))
    out = os.path.join(tmp, "dvd.mp4")
    argv = ["-e", "h264", "-q", "28", "--encoder-profile", "high",
            "--decomb", "-m", "-a", "1,2", "-E", "copy:ac3,aac", "-s", "1",
            "--subtitle-burned", "1", "--previews", str(DVD_PREVIEWS)]
    t0 = time.perf_counter()
    secs, dev_ms, db, rs, spy = disc_job("cli", ["-i", root, "-o", out]
                                          + argv)
    t_cli = time.perf_counter() - t0
    tracks, pk = read_tracks(out)
    ti = tracks[0]
    samples = [p for _, p in pk[0]]
    from handbrake_tpu_torch.sources.mp4 import MP4Demuxer
    d = MP4Demuxer(out)
    chapters = list(d.chapters)
    d.close()
    cs = next((f.settings for f in spy.job.filters
               if f.id == S.FILTER_CROP_SCALE), {})
    crop = [int(cs.get(k, 0)) for k in ("crop-top", "crop-bottom",
                                        "crop-left", "crop-right")]
    scales = (ti.width, ti.height) != (720 - crop[2] - crop[3],
                                       480 - crop[0] - crop[1])
    sx = ti.width / (720 - crop[2] - crop[3])
    sy = ti.height / (480 - crop[0] - crop[1])
    x, y, w, h = DVD_CARD
    rect = (int((x - crop[2] + 4) * sx), int((y - crop[0] + 4) * sy),
            int((w - 8) * sx), int((h - 8) * sy))
    means = luma_means(out, rect)
    before = max(means[:DVD_CARD_AT - 1])
    after = min(means[DVD_CARD_AT + 1:])
    # the last frame, which decomb holds until the flush, keeps the card
    # (ROADMAP 3.11): within the other card frames' range, give or take a
    # level of coding noise
    shown = means[DVD_CARD_AT + 1:-1]
    last_ok = min(shown) - 1 <= means[-1] <= max(shown) + 1
    n_p = spy.p_frames()
    # the same job (the one the CLI built) on the CPU over the first 4
    # pictures (I P B B: display frames 0-3)
    cut, _, _ = dvd_folder(os.path.join(tmp, "dvd_cut"), 4)
    out_cpu = os.path.join(tmp, "dvd_cpu.mp4")
    disc_job("do_job", dataclasses.replace(spy.job, path=cut, file=out_cpu),
             device="cpu")
    cpu_samples = [p for _, p in read_tracks(out_cpu)[1][0]]
    rec = {"phase": "12a", "card": label, "pictures": n,
           "samples": len(samples), "size": [ti.width, ti.height],
           "crop": crop, "scaled": scales,
           "tracks": [(t.kind, t.codec) for t in tracks],
           "chapters": len(chapters),
           "ac3_equal_vob": [p for _, p in pk[1]] == ac3_frames,
           "card_luma_before_max": before, "card_luma_after_min": after,
           "card_luma_last": means[-1], "card_on_last_frame": last_ok,
           "first3_equal_cpu": samples[:N_CPU] == cpu_samples[:N_CPU],
           "deblock264_launches": db, "p_frames": n_p,
           "redos": spy.enc.n_redo, "resample_launches": rs,
           "do_job_s": secs, "fps": n / secs, "cli_s": t_cli,
           "device_ms": dev_ms, "busy_share": dev_ms / (secs * 1e3)}
    print(json.dumps(rec), flush=True)
    print(f"dvd (a): the resample kernel "
          + (f"launched {rs} times for {n} frames: the preset scales "
             f"720x480 to {ti.width}x{ti.height}" if scales else
             f"launched {rs} times: the preset keeps 720x480 (crop "
             f"{crop}), so nothing scales"), flush=True)
    if len(samples) != n or len(chapters) != 2 or not rec["ac3_equal_vob"]:
        raise RuntimeError("the DVD job's mp4 lacks samples, chapters or "
                           "the AC-3 frames")
    if [t.codec for t in tracks[1:3]] != ["ac3", "aac"]:
        raise RuntimeError(f"the DVD job's tracks are {rec['tracks']}")
    if after < before + 60:
        raise RuntimeError("the burned VobSub card does not show")
    if not last_ok:
        raise RuntimeError("the burned VobSub card is dimmer on the last "
                           "frame than on the frames before it")
    if not rec["first3_equal_cpu"]:
        raise RuntimeError("the DVD job's first samples differ from the CPU")
    if db < n_p or db == 0:
        raise RuntimeError("the DVD job did not launch deblock264 for every "
                           "P frame")
    if rs != (n if scales else 0):
        raise RuntimeError("the DVD job's resample launches do not match "
                           "its geometry")
    return rec


def bd_streams(n):
    """12 (b)'s sound and subtitle streams for n pictures: {kind: (stream
    type, PID, stream id, stream_id_extension, frames or display sets,
    their pts)}.  An AC-3 5.1 track (0x81); the committed TrueHD
    fixture's access units (0x83, extension 0x72) with AC-3 5.1
    syncframes as its core (extension 0x76) on one PID; the committed
    E-AC-3 mkv's access units (0x84); DTS-HD, a core 5.1 frame and an
    extension substream saying 8 channels (0x85); a PGS card of
    BD_CARD shown at picture BD_CARD_AT and cleared at BD_CARD_OFF
    (0x90)."""
    from handbrake_tpu_torch.audio.ac3enc import Ac3Encoder
    from handbrake_tpu_torch.sources.mkv import MKVDemuxer
    from handbrake_tpu_torch.subtitles.pgs import build_display_set
    from handbrake_tpu_torch.tools import source_builders as B
    secs = n * FRAME_TICKS / 90000

    def at(k, samples):
        return [DVD_T0 + i * samples * 90000 // 48000 for i in range(k)]

    ac3 = Ac3Encoder(48000, 6, AC3_SRC_BPS)
    frames = ac3.encode(disc_tone(6, secs, 23)) + ac3.flush()
    units = truehd_units()[0]
    core = frames[:-(-len(units) * 40 // 1536)]
    d = MKVDemuxer(os.path.join(B.FIXTURES, "eac3_176x144.mkv"))
    eac3 = [bytes(b.data) for t, b in d.packets() if t == 1]
    d.close()
    dts = [B.dts_core_frame(size=1024, fill=k % 251)
           + B.dts_exss(600, fill=7, asset=(48000, 8, 512))
           for k in range(int(secs * 48000) // 512)]
    pal = np.zeros((256, 4), np.uint8)
    pal[1] = (235, 128, 128, 255)
    x, y, w, h = BD_CARD
    show, off = (DVD_T0 + k * FRAME_TICKS for k in (BD_CARD_AT, BD_CARD_OFF))
    card = np.ones((h, w), np.uint8)
    pgs = [build_display_set(show, card, pal, x, y, screen=(W, H)),
           build_display_set(off, card, pal, 0, 0, screen=(W, H),
                             clear=True)]
    return {"ac3": (0x81, 0x1100, 0xBD, None, frames, at(len(frames), 1536)),
            "truehd": (0x83, 0x1101, 0xFD, 0x72, units, at(len(units), 40)),
            "core": (0x83, 0x1101, 0xFD, 0x76, core, at(len(core), 1536)),
            "eac3": (0x84, 0x1102, 0xFD, None, eac3, at(len(eac3), 1536)),
            "dts": (0x85, 0x1103, 0xFD, None, dts, at(len(dts), 512)),
            "pgs": (0x90, 0x1200, 0xBD, None, pgs, [show, off])}


def truehd_units():
    """The committed TrueHD fixture's access units and libavcodec's
    account of them (its ``.json``)."""
    from handbrake_tpu_torch.tools import source_builders as B
    data = B.fixture("truehd_48k_2.0.thd")
    info = json.loads(B.fixture("truehd_48k_2.0.json"))
    ends = np.cumsum(info["unit_sizes"]).tolist()
    return [data[a:b] for a, b in zip([0] + ends[:-1], ends)], info


def bd_folder(root, stream):
    """12 (b): phase 7's 1080p stream and ``bd_streams`` in a TS (the BD
    PIDs; the TrueHD units 12 a PES), as m2ts over two clips, an MPLS
    with two chapter marks.  Returns (folder, the streams)."""
    from handbrake_tpu_torch.tools import source_builders as B
    secs = len(stream) * FRAME_TICKS / 90000
    tracks = bd_streams(len(stream))
    units = [(DVD_T0 + i * FRAME_TICKS, 0x1011, 0xE0, au,
              DVD_T0 + i * FRAME_TICKS) for i, au in enumerate(stream)]
    pmt = [(0x1B, 0x1011, b"")]
    for kind, (stype, pid, sid, ext, frames, pts) in tracks.items():
        if kind != "core":
            pmt.append((stype, pid, b""))
        per = 12 if kind == "truehd" else 1
        units += [(pts[k], pid, sid, b"".join(frames[k:k + per]), pts[k])
                  + (() if ext is None else (ext,))
                  for k in range(0, len(frames), per)]
    ts = B.build_ts(pmt, units)
    return B.write_bd(root, ts, 2, secs, [(0, 0.0), (1, 0.1)]), tracks


def bd_job(root, out):
    """12 (b)'s CLI arguments: every sound track copied, the PGS
    burned."""
    return ["-i", root, "-o", out, "-e", "h264", "-q", "28",
            "--encoder-profile", "high", "-m", "-a", "1,2,3,4,5", "-E",
            "copy:ac3,copy:truehd,copy:ac3,copy:eac3,copy:dts", "-s", "1",
            "--subtitle-burned", "1", "--previews", str(DVD_PREVIEWS)]


def mkv_luma_means(path, n, rect):
    """The mean luma of ``rect`` (x, y, w, h) in the first n decoded
    frames of an mkv's video track."""
    from handbrake_tpu_torch.codecs.registry import create_video_decoder
    from handbrake_tpu_torch.sources.mkv import MKVDemuxer
    d = MKVDemuxer(path)
    dec = create_video_decoder("h264", d.tracks[0].extradata)
    frames = []
    for trk, b in d.packets():
        if trk == 0 and len(frames) < n:
            frames += dec.feed(b)
    d.close()
    x, y, w, h = rect
    return [float(np.asarray(f.planes[0])[y:y + h, x:x + w].mean())
            for f in frames[:n]]


def phase_bd(tmp, label, stream):
    """12 (b): the BDMV folder through the CLI to mkv, each sound track
    copied (the TrueHD and its AC-3 core apart), the PGS card burned."""
    from handbrake_tpu_torch.audio.frames import truehd_major_sync
    from handbrake_tpu_torch.sources import bd as bdsrc
    root, streams = bd_folder(os.path.join(tmp, "bd"), stream)
    d = bdsrc.open_bd_title(root)[0]
    listing = [(t.kind, t.codec) for t in d.tracks]
    d.close()
    out = os.path.join(tmp, "bd.mkv")
    secs, dev_ms, db, rs, spy = disc_job("cli", bd_job(root, out))
    tracks, pk = read_tracks(out)
    chapters = len(mkv_chapters(out))
    n = len(stream)
    n_p = spy.p_frames()
    copies = {k: [p for _t, p in pk.get(i, [])]
              for i, k in enumerate(("ac3", "truehd", "core", "eac3",
                                     "dts"), 1)}
    units, info = truehd_units()
    samples = [p for _t, p in pk.get(0, [])]
    # the same job the CLI built, on the CPU over the folder's first
    # N_CPU pictures
    cut, _ = bd_folder(os.path.join(tmp, "bd_cut"), stream[:N_CPU])
    out_cpu = os.path.join(tmp, "bd_cpu.mkv")
    disc_job("do_job", dataclasses.replace(spy.job, path=cut, file=out_cpu),
             device="cpu")
    cpu_samples = [p for _t, p in read_tracks(out_cpu)[1][0]]
    x, y, w, h = BD_CARD
    means = mkv_luma_means(out, BD_CARD_AT + 3, (x + 4, y + 4, w - 8, h - 8))
    rec = {"phase": "12b", "card": label, "samples": len(samples),
           "size": [tracks[0].width, tracks[0].height],
           "source_tracks": listing,
           "tracks": [(t.kind, t.codec, t.sample_rate, t.channels)
                      for t in tracks], "chapters": chapters,
           "copies_equal_streams": {k: copies[k] == list(streams[k][4])
                                    for k in copies},
           "truehd_first_major_sync": bool(copies["truehd"]) and
           truehd_major_sync(copies["truehd"][0]) is not None,
           "truehd_blocks": len(copies["truehd"]),
           "card_luma_before": means[0], "card_luma_burned": means[-1],
           "first3_equal_cpu": samples[:N_CPU] == cpu_samples[:N_CPU],
           "deblock264_launches": db, "p_frames": n_p,
           "redos": spy.enc.n_redo, "resample_launches": rs,
           "do_job_s": secs, "fps": n / secs, "device_ms": dev_ms,
           "busy_share": dev_ms / (secs * 1e3)}
    print(json.dumps(rec), flush=True)
    want = [("video", "h264"), ("audio", "ac3"), ("audio", "truehd"),
            ("audio", "ac3"), ("audio", "eac3"), ("audio", "dts"),
            ("subtitle", "pgs")]
    if listing != want:
        raise RuntimeError(f"the Blu-ray title's tracks are {listing}, not "
                           f"{want}")
    if rec["samples"] != n or (tracks[0].width, tracks[0].height) != (W, H) \
            or chapters != 2 or not all(rec["copies_equal_streams"].values()) \
            or not rec["truehd_first_major_sync"]:
        raise RuntimeError("the Blu-ray job's mkv lacks frames or chapters, "
                           "or a copy is not its stream's frames")
    labels = [t[2:] for t in rec["tracks"][1:6]]
    if labels != [(48000, 6), (info["decoded_sample_rate"],
                               info["decoded_channels"]), (48000, 6),
                  (48000, 2), (48000, 8)]:
        raise RuntimeError(f"the Blu-ray copies are labelled {labels}")
    if not rec["first3_equal_cpu"]:
        raise RuntimeError("the Blu-ray job's first samples differ from the "
                           "CPU's")
    if means[-1] < means[0] + 60:
        raise RuntimeError("the burned PGS card does not show")
    if rs != 0 or db != n_p + spy.enc.n_redo or db == 0:
        raise RuntimeError("the Blu-ray job's launches: resample "
                           f"{rs} (0 expected), deblock264 {db} for {n_p} "
                           f"P frames and {spy.enc.n_redo} redos")
    return rec


def mkv_chapters(path):
    from handbrake_tpu_torch.sources.mkv import MKVDemuxer
    d = MKVDemuxer(path)
    try:
        return list(d.chapters)
    finally:
        d.close()


def broadcast_ts(path, stream):
    """12 (c): the stream and the MP2 fixture's frames that sound under
    it, 188-byte packets, with a null packet whose sync byte is corrupt
    after the middle packet."""
    from handbrake_tpu_torch.tools import source_builders as B
    mp2 = B.fixture("mp2_48k_stereo.mp2")
    n_mp2 = -(-len(stream) * FRAME_TICKS // 2160)
    units = [(DVD_T0 + i * FRAME_TICKS, 0x100, 0xE0, au,
              DVD_T0 + i * FRAME_TICKS) for i, au in enumerate(stream)]
    units += [(DVD_T0 + k * 2160, 0x101, 0xC0, mp2[k * 384:(k + 1) * 384],
               DVD_T0 + k * 2160) for k in range(n_mp2)]
    ts = B.build_ts([(0x1B, 0x100, b""), (0x03, 0x101, b"")], units)
    mid = len(ts) // 188 // 2 * 188
    null = b"\x00\x1f\xff\x10" + b"\xff" * 184     # sync 0x47 corrupt
    with open(path, "wb") as f:
        f.write(ts[:mid] + null + ts[mid:])
    return path


def phase_ts(tmp, label, stream):
    """12 (c): the broadcast TS through work.do_job to mp4 with AAC."""
    from handbrake_tpu_torch.job import schema as S

    def job(src, out):
        j = S.Job(path=src, file=out, mux="mp4", vcodec="h264",
                  quality=28.0, encoder_profile="high")
        j.audio = [S.AudioJobTrack(track=0, encoder="aac")]
        return j

    src = broadcast_ts(os.path.join(tmp, "bc.ts"), stream)
    out = os.path.join(tmp, "bc.mp4")
    secs, dev_ms, db, rs, spy = disc_job("do_job", job(src, out))
    tracks, pk = read_tracks(out)
    cut = broadcast_ts(os.path.join(tmp, "bc_cut.ts"), stream[:N_CPU])
    out_cpu = os.path.join(tmp, "bc_cpu.mp4")
    disc_job("do_job", job(cut, out_cpu), device="cpu")
    cpu_pk = read_tracks(out_cpu)[1]
    n = len(stream)
    n_p = spy.p_frames()
    samples = [p for _, p in pk[0]]
    rec = {"phase": "12c", "card": label, "samples": len(samples),
           "tracks": [(t.kind, t.codec) for t in tracks],
           "aac_packets": len(pk.get(1, [])),
           "first3_equal_cpu": samples[:N_CPU] == [p for _, p in
                                                  cpu_pk[0]][:N_CPU],
           "deblock264_launches": db, "p_frames": n_p,
           "redos": spy.enc.n_redo, "resample_launches": rs,
           "do_job_s": secs, "fps": n / secs, "device_ms": dev_ms,
           "busy_share": dev_ms / (secs * 1e3)}
    print(json.dumps(rec), flush=True)
    if len(samples) != n or not rec["first3_equal_cpu"] \
            or rec["tracks"][1] != ("audio", "aac") \
            or not rec["aac_packets"]:
        raise RuntimeError("the TS job's mp4 lacks samples or its AAC "
                           "track, or its first samples differ from the CPU")
    if db != n_p + spy.enc.n_redo or db == 0:
        raise RuntimeError("the TS job did not launch deblock264 once per "
                           "analysed P frame")
    return rec


def phase_mjpeg(tmp, label):
    """12 (d): the committed MJPEG AVI through work.do_job to mp4; the
    planes the job's encoder was given equal the port's MJPEG decoder
    run on the host over the AVI's packets."""
    from handbrake_tpu_torch.codecs.registry import MJPEGVideoDecoder
    from handbrake_tpu_torch.job import schema as S
    from handbrake_tpu_torch.sources.avi import AVIDemuxer
    from handbrake_tpu_torch.tools import source_builders as B
    avi = os.path.join(B.FIXTURES, "mjpeg_640x480.avi")
    out = os.path.join(tmp, "avi.mp4")
    secs, dev_ms, db, rs, spy = disc_job(
        "do_job", S.Job(path=avi, file=out, mux="mp4", vcodec="h264",
                        quality=28.0, encoder_profile="high"), keep=MJPEG_N,
        cross_check=True)
    ti, samples = read_mp4(out)
    d = AVIDemuxer(avi)
    dec = MJPEGVideoDecoder()
    host = [f.planes for _, b in d.packets() for f in dec.feed(b)]
    d.close()
    n_p = spy.p_frames()
    rec = {"phase": "12d", "card": label, "samples": len(samples),
           "size": [ti.width, ti.height],
           "equal_cpu": same_frames([f[:3] for f in spy.frames], host),
           "deblock264_launches": db, "p_frames": n_p,
           "redos": spy.enc.n_redo, "do_job_s": secs,
           "fps": len(samples) / secs, "device_ms": dev_ms,
           "busy_share": dev_ms / (secs * 1e3)}
    print(json.dumps(rec), flush=True)
    if len(samples) != MJPEG_N or (ti.width, ti.height) != (640, 480) \
            or not rec["equal_cpu"]:
        raise RuntimeError("the MJPEG job's mp4 lacks frames, or the planes "
                           "its encoder was given differ from the host "
                           "decode")
    if db != n_p + spy.enc.n_redo or db == 0:
        raise RuntimeError("the MJPEG job did not launch deblock264 once "
                           "per analysed P frame")
    return rec


def decoder_host_ms():
    """12 (e): host ms a frame of the MPEG-2 decoder on the 720x480
    fixture's first DVD_TIMED pictures (I P B B P B B P) and of the MJPEG
    decoder on the AVI (6)."""
    from handbrake_tpu_torch.codecs.mpeg2 import Mpeg2Decoder
    from handbrake_tpu_torch.codecs.registry import MJPEGVideoDecoder
    from handbrake_tpu_torch.sources.avi import AVIDemuxer
    from handbrake_tpu_torch.tools import source_builders as B
    es = b"".join(B.split_pictures(B.fixture("mpeg2_720x480.m2v"))
                  [:DVD_TIMED])
    t0 = time.perf_counter()
    n2 = len(Mpeg2Decoder().decode(es))
    mpeg2_ms = (time.perf_counter() - t0) / n2 * 1e3
    d = AVIDemuxer(os.path.join(B.FIXTURES, "mjpeg_640x480.avi"))
    pkts = [b for _, b in d.packets()]
    d.close()
    dec = MJPEGVideoDecoder()
    dec.feed(pkts[0])
    t0 = time.perf_counter()
    for _ in range(3):
        for b in pkts:
            dec.feed(b)
    mjpeg_ms = (time.perf_counter() - t0) / (3 * len(pkts)) * 1e3
    return n2, mpeg2_ms, mjpeg_ms


def phase_discs(tmp, label, stream, deblock_ms):
    """12: DVD, Blu-ray, broadcast TS and MJPEG sources on the card, one
    JSON line a part.  Returns their numbers."""
    t0 = time.perf_counter()
    rec = {}
    for part, run in (("dvd", lambda: phase_dvd(tmp, label)),
                      ("bd", lambda: phase_bd(tmp, label, stream)),
                      ("ts", lambda: phase_ts(tmp, label, stream)),
                      ("mjpeg", lambda: phase_mjpeg(tmp, label))):
        t1 = time.perf_counter()
        rec[part] = run()
        rec[part]["part_s"] = time.perf_counter() - t1
    n2, mpeg2_ms, mjpeg_ms = decoder_host_ms()
    rec["timings"] = {
        "phase": "12e", "card": label,
        "fps": {k: rec[k]["fps"] for k in ("dvd", "bd", "ts", "mjpeg")},
        "busy_share": {k: rec[k]["busy_share"]
                       for k in ("dvd", "bd", "ts", "mjpeg")},
        "part_s": {k: rec[k]["part_s"] for k in ("dvd", "bd", "ts", "mjpeg")},
        "mpeg2_host_ms_per_720x480_frame": mpeg2_ms, "mpeg2_frames": n2,
        "mjpeg_host_ms_per_640x480_frame": mjpeg_ms,
        "deblock264_ms_main_path_p_frame": deblock_ms}
    print(json.dumps(rec["timings"]), flush=True)
    rec["seconds"] = time.perf_counter() - t0
    print(f"phase 12 ({label}): {rec['seconds']:.1f} s", flush=True)
    return rec


def hevc_analyzer_ops(cw, ch) -> int:
    """Integer operations of one HEVC CTU analysis on these inputs: the
    4x4 decimation of both planes, the 121 coarse shifts, the 49
    full-pel candidates, the 16 quarter-pel grids (8 taps, a multiply and
    an add each: 3 horizontal phases on 40x33, 4 x 3 vertical on 33x33)
    and the 25 quarter-pel candidates of every CTU."""
    n, h, w = cw * ch, 32 * ch, 32 * cw
    return (2 * h * w + 121 * (h // 4) * (w // 4) * SAD_OPS
            + n * 49 * 1024 * SAD_OPS
            + n * (40 * 33 * 3 + 33 * 33 * 4 * 3) * 8 * 2
            + n * 25 * 1024 * SAD_OPS)


def analyzer_bound(nbytes, ops) -> dict:
    t_bytes = nbytes / MEM_BW * 1e3
    t_ops = ops / SCALAR_RATE * 1e3
    return {"bytes": nbytes, "ops": ops, "bytes_ms": t_bytes,
            "ops_ms": t_ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_analyzers(label):
    """13 (a): the HEVC CTU analyzer (Main, Main 10) and the AV1 motion
    search on 1080p coded planes, on the card against the CPU (mv and sad
    equal), timed by CUDA events.  Returns their numbers."""
    import torch
    from handbrake_tpu_torch.codecs.av1.analyzer import motion_search
    from handbrake_tpu_torch.codecs.hevc.analyzer import analyze_ctus
    from handbrake_tpu_torch.utils.synth import make_clip
    ref, src = (np.pad(f[0], ((0, HV_ROWS - H), (0, 0)), mode="edge")
                for f in make_clip(W, H, 2, seed=13))
    cw, ch = W // 32, HV_ROWS // 32
    cases = {
        "hevc_main": (lambda a, b: analyze_ctus(a, b, cw, ch, 255),
                      src, ref, 1),
        "hevc_main10": (lambda a, b: analyze_ctus(a, b, cw, ch, 1023),
                        src.astype(np.int16) << 2,
                        ref.astype(np.int16) << 2, 2),
        "av1": (lambda a, b: motion_search(a, b, 8), src, ref, 1)}
    rec = {}
    for name, (fn, s_np, r_np, bps) in cases.items():
        s_cpu, r_cpu = torch.from_numpy(s_np), torch.from_numpy(r_np)
        t0 = time.perf_counter()
        want = fn(s_cpu, r_cpu)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        s_dev, r_dev = s_cpu.cuda(), r_cpu.cuda()
        got = fn(s_dev, r_dev)
        if isinstance(want, dict):
            want, got = (want["mv"], want["sad"]), (got["mv"], got["sad"])
        equal = all(torch.equal(a, b.cpu()) for a, b in zip(want, got))
        ms = cuda_ms(lambda: fn(s_dev, r_dev), AN_REPS)
        if name.startswith("hevc"):
            ops = hevc_analyzer_ops(cw, ch)
            out_bytes = cw * ch * 12          # mv (2 x int32), sad (f32)
        else:
            ops = (17 * 17) * HV_ROWS * W * SAD_OPS
            out_bytes = (HV_ROWS // 16) * (W // 16) * 12
        b = analyzer_bound(2 * HV_ROWS * W * bps + out_bytes, ops)
        rec[name] = {"equal": equal, "ms": ms, "cpu_ms": cpu_ms, **b}
        print(f"13 (a) {name} ({label}): {W}x{HV_ROWS} planes, card and "
              f"CPU equal (mv, sad): {equal}; {ms:.4f} ms a call (events, "
              f"median of {AN_REPS}); bound "
              f"{b['bound_ms'] * 1e3:.2f} us by {b['bound_by']} "
              f"({b['bytes'] / 1e6:.2f} MB, {b['ops'] / 1e9:.3f} G int "
              f"ops); the CPU {cpu_ms:.1f} ms", flush=True)
        if not equal:
            raise RuntimeError(f"13 (a): the {name} analysis on the card "
                               f"differs from the CPU's")
    return rec


def analyzers_traced(label, rec, fresh):
    """13 (a): one call's device ms, kernels and copies/sets of the Main
    HEVC analyzer and the AV1 search, traced by
    ``tools/profile_analyzers.py`` in a fresh process (a trace taken here,
    after phases 1-12, has lacked a call's first few dozen kernels)."""
    for name, key in (("hevc_main", "hevc"), ("av1", "av1")):
        f = fresh[key]
        rec[name].update(device_ms=f["device_ms"], kernels=f["kernels"],
                         copies_sets=f["copies_sets"],
                         fresh_events_ms=f["events_ms"])
        print(f"13 (a) {name} ({label}): a fresh process's trace of one "
              f"call: device {f['device_ms']:.4f} ms, {f['kernels']} "
              f"kernels and {f['copies_sets']} copies/sets; events there "
              f"{f['events_ms']:.4f} ms", flush=True)
        if f["kernels"] <= 0 or f["device_ms"] <= 0:
            raise RuntimeError(f"13 (a): the trace saw no {name} kernel")


def write_y4m10(path, frames, w, h):
    """A 4:2:0 10-bit y4m (C420p10, little-endian samples) of 8-bit
    frames scaled by 4."""
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F30000:1001 Ip A1:1 "
                f"C420p10\n".encode())
        for planes in frames:
            f.write(b"FRAME\n")
            for p in planes:
                f.write((p.astype("<u2") << 2).tobytes())
    return path


PROCS = []        # step 13's helper processes, stopped when it ends


def start_process(tmp, name, argv, card=False, threads=2):
    """A process of its own beside this one's run: on the CPU (no card
    visible to it), or with card=True on this process's card, with
    `threads` OpenMP threads.  (Popen, log file)."""
    log = open(os.path.join(tmp, f"{name}.log"), "w")
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, OMP_NUM_THREADS=str(threads), PYTHONPATH=root)
    if not card:
        env["CUDA_VISIBLE_DEVICES"] = ""
    p = subprocess.Popen([sys.executable, *argv], cwd=root, env=env,
                         stdout=log, stderr=subprocess.STDOUT)
    PROCS.append(p)
    return p, log


def finish_process(run) -> str:
    """Wait for a process of start_process; its output's last line."""
    p, log = run
    rc = p.wait()
    log.close()
    with open(log.name) as f:
        text = f.read()
    if rc != 0:
        print(text[-4000:], flush=True)
        raise RuntimeError(f"13: the process of {log.name} exited {rc}")
    return text.strip().splitlines()[-1]


def start_cpu_run(tmp, codec, src):
    """The CLI job of the codec's preset on the CPU: (process, mkv)."""
    out = os.path.join(tmp, f"{codec}_cpu.mkv")
    return start_process(tmp, f"{codec}_cpu", [
        "-m", "handbrake_tpu_torch.cli", "-i", src, "-o", out, "-Z",
        HV_PRESETS[codec], "--device", "cpu"]), out


def save_recons(npz, recons):
    """Reconstructions cropped to the picture, for a decode check."""
    np.savez(npz, **{f"{i}_{k}": p for i, r in enumerate(recons)
                     for k, p in enumerate(crop(r))})


def load_recons(npz) -> list:
    z = np.load(npz)
    return [tuple(z[f"{i}_{k}"] for k in range(3))
            for i in range(len(z.files) // 3)]


def start_decode_check(tmp, name, codec, mkv, npz):
    """decode_check (below) in a process of its own, on an mkv and the
    reconstructions save_recons wrote to npz."""
    return start_process(tmp, f"{name}_decode", [
        os.path.abspath(__file__), "--decode-check", codec, mkv, npz])


def decode_result(codec, mkv, recons) -> dict:
    """The port's decoder (the registry's) on an mkv's video samples
    against reconstructions: frames, equal, host ms a frame, dtype."""
    ti, samples = read_mkv(mkv)
    frames, sec = decode_all(samples, bytes(ti.extradata or b""), codec)
    return {"codec": codec, "frames": len(frames),
            "equal": recons_equal(frames, recons),
            "ms": sec / max(1, len(frames)) * 1e3,
            "dtype": str(frames[0][0].dtype) if frames else None}


def decode_check(codec, mkv, npz) -> int:
    """Step 13's decode-check process: decode_result on reconstructions
    saved by start_decode_check, printed as one JSON line."""
    print(json.dumps(decode_result(codec, mkv, load_recons(npz))))
    return 0


def recons_equal(frames, recons) -> bool:
    """Decoded frames equal to the encoder's reconstructions, cropped
    to the pictures' size."""
    return len(frames) == len(recons) and all(
        all(np.array_equal(d, r[:d.shape[0], :d.shape[1]])
            for d, r in zip(f, rc)) for f, rc in zip(frames, recons))


def card_walker_job(tmp, codec, src, on_frame=None):
    """13 (b), (c): the 1080p clip through the CLI with the codec's MKV
    preset on the card, under the profiler, each frame's access unit and
    encoder handed to `on_frame`.  Returns its numbers, the mkv and the
    encoder's reconstructions."""
    import torch
    from handbrake_tpu_torch.cli.__main__ import main as cli_main
    from handbrake_tpu_torch.codecs.av1 import analyzer as av1_an
    from handbrake_tpu_torch.codecs.hevc import analyzer as hevc_an
    from handbrake_tpu_torch.tools import profile_job as pj
    an = hevc_an if codec == "hevc" else av1_an
    out = os.path.join(tmp, f"{codec}.mkv")
    with pj.JobSpy(recons=True, on_frame=on_frame) as spy:
        reset_counts()
        an.calls = 0
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            rc = cli_main(["-i", src, "-o", out, "-Z", HV_PRESETS[codec]])
            torch.cuda.synchronize()
        calls = an.calls
    if rc != 0:
        raise RuntimeError(f"13: the {codec} job exited {rc}")
    busy = device_busy_ms(prof)
    rec = {"do_job_s": spy.seconds, "busy_ms": busy,
           "busy_share": busy / (spy.seconds * 1e3),
           "walker_i_s": statistics.mean(t for i, t in spy.walker if i),
           "walker_p_s": statistics.mean(t for i, t in spy.walker if not i),
           "analyzer_calls": calls, "p_frames": spy.p_frames()}
    return rec, out, spy.recons


def crop(planes) -> tuple:
    """A frame's planes cut to the picture, as 8- or 16-bit samples."""
    return tuple(p[:H >> (k > 0), :W >> (k > 0)].astype(
        np.uint8 if p.dtype == np.uint8 else np.uint16)
        for k, p in enumerate(planes))


def stream_decode(codec, conn):
    """The port's decoder (the registry's) on access units as a walker
    codes them, each held to the encoder's reconstruction sent with it;
    None ends the stream.  Sends back frames, equal, host ms a frame."""
    from handbrake_tpu_torch.codecs.registry import create_video_decoder
    from handbrake_tpu_torch.core.buffer import Buffer
    dec = create_video_decoder(codec)
    n, equal, sec = 0, True, 0.0
    while (item := conn.recv()) is not None:
        au, recon = item
        t0 = time.perf_counter()
        frames = [f.planes for f in dec.feed(Buffer(data=au, pts=n))]
        sec += time.perf_counter() - t0
        equal = equal and recons_equal(frames, [recon])
        n += len(frames)
    conn.send({"codec": codec, "frames": n, "equal": equal,
               "ms": sec / max(1, n) * 1e3, "dtype": "uint8"})


def walker_job_process(codec, src, tmp) -> int:
    """Step 13's card process: card_walker_job with its access units
    decoded as they come, in a process of its own, against the
    reconstructions; the reconstructions saved to
    ``<tmp>/<codec>_recons.npz``; its numbers printed as one JSON
    line."""
    import multiprocessing
    one_card()
    ctx = multiprocessing.get_context("spawn")
    conn, child = ctx.Pipe()
    dec = ctx.Process(target=stream_decode, args=(codec, child))
    dec.start()
    aus = []

    def on_frame(au, enc):
        aus.append(au)
        conn.send((au, crop((enc.recon_y, enc.recon_u, enc.recon_v))))
    ok = False
    try:
        rec, out, recons = card_walker_job(tmp, codec, src, on_frame)
        conn.send(None)
        rec["decode"] = conn.recv()
        ok = True
    finally:
        if not ok:
            dec.kill()
        dec.join()
    save_recons(os.path.join(tmp, f"{codec}_recons.npz"), recons)
    _ti, samples = read_mkv(out)
    # the mkv's samples are the access units decoded above (HEVC's
    # without the parameter sets, which went to its hvcC)
    rec["samples_are_the_aus"] = samples == aus if codec == "av1" else \
        samples[1:] == aus[1:]
    print(json.dumps(rec))
    return 0


def check_walker_job(label, codec, rec, out, cpu_run):
    """The walker job's mkv: its samples, size and configuration, its
    first samples against the CPU run's, the analyzer once a P frame."""
    ti, samples = read_mkv(out)
    priv = bytes(ti.extradata or b"")
    cfg_ok = (priv[:1] == b"\x01" and len(priv) > 23) if codec == "hevc" \
        else priv[:1] == b"\x81"
    cpu_proc, cpu_out = cpu_run
    finish_process(cpu_proc)
    _ti, cpu_samples = read_mkv(cpu_out)
    same_cpu = samples[:HV_CPU] == cpu_samples[:HV_CPU] and \
        len(cpu_samples) == HV_CPU
    rec["fps"] = len(samples) / rec["do_job_s"]
    rec["bytes"] = sum(map(len, samples))
    print(f"13 ({codec}, {label}): {W}x{H} y4m, CLI -Z \"{HV_PRESETS[codec]}"
          f"\": mkv {len(samples)} samples at {ti.width}x{ti.height} "
          f"({ti.codec}, CodecPrivate {'hvcC' if codec == 'hevc' else 'av1C'}"
          f": {cfg_ok}), {rec['bytes']} bytes; the first {HV_CPU} samples "
          f"equal to the CPU run's: {same_cpu}; analyzer calls "
          f"{rec['analyzer_calls']} for {rec['p_frames']} P frames; do_job "
          f"{rec['do_job_s']:.2f} s, {rec['fps']:.3f} fps; the walker "
          f"{rec['walker_i_s']:.2f} s an I frame, {rec['walker_p_s']:.2f} s "
          f"a P frame (host); the card busy {rec['busy_ms']:.2f} ms, "
          f"{100 * rec['busy_share']:.3f} % of do_job", flush=True)
    if len(samples) != HV_N or (ti.width, ti.height) != (W, H) or \
            ti.codec != codec or not cfg_ok:
        raise RuntimeError(f"13: the {codec} mkv lacks samples or its "
                           f"configuration, or has another size")
    if not same_cpu or not rec["samples_are_the_aus"]:
        raise RuntimeError(f"13: the {codec} stream differs from the CPU's, "
                           f"or the mkv's samples from the encoder's "
                           f"access units")
    if rec["analyzer_calls"] != rec["p_frames"] or not rec["p_frames"]:
        raise RuntimeError(f"13: the {codec} analyzer ran "
                           f"{rec['analyzer_calls']} times for "
                           f"{rec['p_frames']} P frames")


def decoded(rec, name, d, label, dtype="uint8"):
    """Hold a decode result (decode_result's) to the reconstructions."""
    rec["decoder_ms"] = d["ms"]
    print(f"13 ({name}, {label}): its stream decoded by the port's "
          f"{d['codec']} decoder: {d['frames']} frames ({d['dtype']}), equal "
          f"to the encoder's reconstructions: {d['equal']}; "
          f"{d['ms']:.0f} ms a 1080p frame on the host", flush=True)
    if not d["equal"] or d["dtype"] != dtype:
        raise RuntimeError(f"13: the {name} stream does not decode to the "
                           f"encoder's reconstructions")


def phase_hevc_av1(tmp, label):
    """13: HEVC and AV1 at 1080p on the card, one JSON line for the
    phase.  Returns its numbers.  Its helper processes are stopped when
    it ends, whether it passes or fails."""
    try:
        return hevc_av1_parts(tmp, label)
    finally:
        for p in PROCS:
            if p.poll() is None:
                p.kill()
            p.wait()


def hevc_av1_parts(tmp, label):
    from handbrake_tpu_torch.cli.__main__ import main as cli_main
    from handbrake_tpu_torch.tools import profile_job as pj
    from handbrake_tpu_torch.utils.synth import make_clip, write_y4m
    t0 = time.perf_counter()
    frames = make_clip(W, H, HV_N, seed=13)
    src = write_y4m(os.path.join(tmp, "hv.y4m"), frames, W, H)
    src3 = write_y4m(os.path.join(tmp, "hv3.y4m"), frames[:HV_CPU], W, H)
    # the same jobs on the CPU over the first frames, and (b), (c) on the
    # card, each in a process of its own (a walker holds its process's
    # GIL; a fresh process's trace is whole)
    cpu = {c: start_cpu_run(tmp, c, src3) for c in HV_PRESETS}
    cards = {c: start_process(tmp, f"{c}_card", [
        os.path.abspath(__file__), "--walker-job", c, src, tmp], card=True)
        for c in HV_PRESETS}
    # (a) card against CPU here while those start, then the analyzers'
    # device time traced in a fresh process
    rec = {"analyzers": phase_analyzers(label)}
    fresh = json.loads(finish_process(start_process(tmp, "analyzers", [
        "-m", "handbrake_tpu_torch.tools.profile_analyzers", "--json"],
        card=True)))
    analyzers_traced(label, rec["analyzers"], fresh)
    # (d) a Main 10 job from a 10-bit y4m
    src10 = write_y4m10(os.path.join(tmp, "hv10.y4m"), frames[:HV_M10_N],
                        W, H)
    out10 = os.path.join(tmp, "main10.mkv")
    with pj.JobSpy(recons=True) as spy:
        rc = cli_main(["-i", src10, "-o", out10, "-e", "x265", "-q", "28",
                       "--encoder-profile", "main10"])
    ti, samples = read_mkv(out10)
    npz10 = os.path.join(tmp, "main10_recons.npz")
    save_recons(npz10, spy.recons)
    m10_check = start_decode_check(tmp, "main10", "hevc", out10, npz10)
    rec["main10"] = {"fps": len(samples) / spy.seconds,
                     "walker_s": [t for _i, t in spy.walker]}
    print(f"13 (d) ({label}): a 10-bit y4m through the CLI with -e x265 "
          f"--encoder-profile main10: {len(samples)} samples at "
          f"{ti.width}x{ti.height}, encoder bit depth {spy.enc.bd}; do_job "
          f"{spy.seconds:.2f} s, {rec['main10']['fps']:.3f} fps", flush=True)
    if rc != 0 or len(samples) != HV_M10_N or spy.enc.bd != 10:
        raise RuntimeError("13 (d): the Main 10 job failed")

    def collect(c):
        rec[c] = json.loads(finish_process(cards[c]))
        check_walker_job(label, c, rec[c], os.path.join(tmp, f"{c}.mkv"),
                         cpu[c])
        decoded(rec[c], c, rec[c].pop("decode"), label)
    collect("hevc")
    hevc_source(label, rec, tmp, cli_main, pj)
    collect("av1")
    decoded(rec["main10"], "main10", json.loads(finish_process(m10_check)),
            label, "uint16")
    rec["seconds"] = time.perf_counter() - t0
    print(json.dumps({"phase": "13", "card": label, **rec}), flush=True)
    print(f"phase 13 ({label}): {rec['seconds']:.1f} s", flush=True)
    return rec


def hevc_source(label, rec, tmp, cli_main, pj):
    """13 (d): (b)'s mkv through the CLI to H.264 High mp4; the planes
    the H.264 encoder is given must equal the HEVC encoder's
    reconstructions."""
    out = os.path.join(tmp, "from_hevc.mp4")
    with pj.JobSpy(keep=HV_N) as spy:
        rc = cli_main(["-i", os.path.join(tmp, "hevc.mkv"), "-o", out, "-e",
                       "h264", "-q", "28", "--encoder-profile", "high",
                       "--previews", "1"])
    ti, samples = read_mp4(out)
    same = recons_equal([f[:3] for f in spy.frames],
                        load_recons(os.path.join(tmp, "hevc_recons.npz")))
    rec["hevc_source"] = {"fps": len(samples) / spy.seconds,
                          "do_job_s": spy.seconds}
    print(f"13 (d) ({label}): the HEVC mkv through the CLI to H.264 mp4: "
          f"{len(samples)} samples at {ti.width}x{ti.height}; the planes "
          f"the encoder was given equal the HEVC encoder's "
          f"reconstructions: {same}; do_job {spy.seconds:.2f} s, "
          f"{rec['hevc_source']['fps']:.3f} fps", flush=True)
    if rc != 0 or len(samples) != HV_N or (ti.width, ti.height) != (W, H) \
            or not same:
        raise RuntimeError("13 (d): the HEVC source did not transcode to "
                           "its decoded frames")

def cards_at_start() -> list:
    """The card indexes this process may use, read before one_card()
    hides all but the first (CUDA is not started yet)."""
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    if vis is not None:
        return [v.strip() for v in vis.split(",") if v.strip()]
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [str(k) for k, line in enumerate(
        x for x in out.splitlines() if x.startswith("GPU "))]


def mesh_rank_process(kind, out_dir, *argv) -> int:
    """One rank of a step 14 world, started by torchrun on its card
    (``utils/device.py`` deals the ranks over the visible cards).  "cli":
    ``cli.__main__.main(argv)`` under torch.profiler (rank 0 runs the
    job, the others serve it), with the job's do_job seconds, the card's
    busy ms from the raw trace and the resample launches; "tiles": rank 0
    holds nlmeans with tile_parallel over the world against the untiled
    filter.  Writes its numbers to out_dir/rank<r>.json."""
    import torch

    from handbrake_tpu_torch.parallel.mesh import init_world
    from handbrake_tpu_torch.utils.device import resolve_device
    world = init_world("cuda")      # None: a world of one, no group
    rank = world.rank if world is not None else 0
    rec = {"rank": rank, "rc": 0,
           "device": str(world.device if world else resolve_device()),
           "backend": world.backend if world is not None else None}
    if kind == "cli":
        from handbrake_tpu_torch.cli.__main__ import main as cli_main
        from handbrake_tpu_torch.filters import resample_cuda
        from handbrake_tpu_torch.tools.profile_job import JobSpy
        reset_counts()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with JobSpy() as spy, torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            rec["rc"] = cli_main(list(argv))
            torch.cuda.synchronize()
            rec["wall_s"] = time.perf_counter() - t0
        rec.update(job_s=spy.seconds, device_ms=device_busy_ms(prof),
                   resample_launches=resample_cuda.launches,
                   mesh=dict(world.stats) if world is not None else None)
    elif world.rank != 0:
        world.serve()
    else:
        try:
            rec.update(mesh_tiles(world.size))
        finally:
            world.close()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    return rec["rc"]


def mesh_tiles(n) -> dict:
    """Rank 0 of 14 (c): nlmeans with tile_parallel n over the world on
    a 1080p 4:2:0 frame (the frame before as its temporal reference)
    against the filter without it, bit for bit; each timed in turns."""
    import torch

    from handbrake_tpu_torch.core.buffer import PIX_FMTS, Buffer, Geometry
    from handbrake_tpu_torch.filters import base
    from handbrake_tpu_torch.job import schema as S
    from handbrake_tpu_torch.utils.synth import make_clip
    planes = [[torch.from_numpy(p).cuda() for p in f]
              for f in make_clip(W, H, 2, seed=17)]
    filters, outs = {}, {}
    for tp in (0, n):
        f = base.create_filter(S.FILTER_NLMEANS, {"tile_parallel": tp})
        f.init(base.FilterInit(geometry=Geometry(W, H), device="cuda",
                               pix_fmt=PIX_FMTS["yuv420p"]))
        filters[tp], outs[tp] = f, []
        for k, p in enumerate(planes):
            outs[tp] += f.work(Buffer(planes=list(p),
                                      pix_fmt=PIX_FMTS["yuv420p"],
                                      pts=k))[0].planes
    turns = {0: [], n: []}
    for tp in (0, n, n, 0):
        turns[tp].append(cuda_ms(lambda: filters[tp].work(Buffer(
            planes=list(planes[1]), pix_fmt=PIX_FMTS["yuv420p"], pts=1)),
            NL_REPS))
    return {"tiles": n, "equal_untiled": all(
        torch.equal(a, b) for a, b in zip(outs[n], outs[0])),
        "ms_untiled": statistics.mean(turns[0]),
        "ms_tiled": statistics.mean(turns[n]),
        "ms_turns": {str(k): v for k, v in turns.items()}}


def torchrun_ranks(tmp, name, n, kind, argv, env=None):
    """This script's ``--mesh-rank`` on n ranks under torchrun (its own
    session, killed at MESH_LIMIT_S); every rank's numbers, the
    seconds."""
    from handbrake_tpu_torch.parallel.launch import torchrun
    out_dir = os.path.join(tmp, name)
    os.makedirs(out_dir, exist_ok=True)
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    rc, out = torchrun(n, [os.path.join(root, "chip_smoke.py"),
                           "--mesh-rank", kind, out_dir, *argv],
                       limit_s=MESH_LIMIT_S, cwd=root,
                       env=dict(os.environ, PYTHONPATH=root, **(env or {})))
    secs = time.perf_counter() - t0
    if rc != 0:
        print(out[-6000:], flush=True)
        raise RuntimeError(f"14: the {name} world of {n} ranks exited {rc}")
    ranks = []
    for r in range(n):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks, secs


def mesh_job(tmp, name, n, argv, out, want, env=None) -> dict:
    """Job (a)'s --gop-parallel run over n ranks (n = 1: one process,
    no process group), each a fresh process: its file against the
    one-rank file, fps, each rank's device ms and busy share over the
    job (an NCCL rank's receive kernels count as busy while they wait),
    resample launches on each rank."""
    ranks, secs = torchrun_ranks(tmp, name, n, "cli", argv, env)
    job_s = ranks[0]["job_s"]
    return {"ranks": n, "backend": ranks[0]["backend"],
            "devices": [r["device"] for r in ranks],
            "equal_one_rank": file_bytes(out) == want,
            "fps": N_FRAMES / job_s, "job_s": job_s, "torchrun_s": secs,
            "device_ms": [r["device_ms"] for r in ranks],
            "busy_share": [r["device_ms"] / (job_s * 1e3) for r in ranks],
            "resample_launches": [r["resample_launches"] for r in ranks],
            "wire": [r["mesh"] for r in ranks]}


def phase_mesh(tmp, label, gp) -> dict:
    """14: job (a)'s letterboxed source with --gop-parallel GP_N over
    MESH_RANKS ranks on this card (gloo) under torchrun, against phase 11
    (c)'s one-rank files: (a) with per-rank numbers, (b) to a bitrate
    with --two-pass through ``-m handbrake_tpu_torch.cli`` itself; (c)
    nlmeans in row tiles over the ranks; (d) the same over NCCL on
    min(NCCL_MAX, cards) cards, where the run started with two or
    more."""
    from handbrake_tpu_torch.parallel.launch import torchrun
    from handbrake_tpu_torch.tools import profile_job as pj
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(tmp, "gp.y4m")
    one = file_bytes(os.path.join(tmp, "gp.mp4"))
    rec = {"phase": "14", "card": label}
    out = os.path.join(tmp, "gp_ranks.mp4")
    argv = pj.letterbox_argv(src, out) + ["--gop-parallel", str(GP_N)]
    # the same job in one fresh process: torchrun's ranks start cold,
    # while 11 (c) ran late in this warm one
    out_1 = os.path.join(tmp, "gp_one.mp4")
    rec["one"] = mesh_job(tmp, "mesh_one", 1, pj.letterbox_argv(src, out_1)
                          + ["--gop-parallel", str(GP_N)], out_1, one)
    rec["a"] = mesh_job(tmp, "mesh_a", MESH_RANKS, argv, out, one)
    rec["a"]["warm_one_rank_fps"] = gp["fps"]
    out_b = os.path.join(tmp, "gp_rate_ranks.mp4")
    t1 = time.perf_counter()
    rc, log = torchrun(MESH_RANKS, [
        "-m", "handbrake_tpu_torch.cli", *pj.letterbox_argv(src, out_b),
        "--gop-parallel", str(GP_N), "-b", str(GP_KBPS), "--two-pass"],
        limit_s=MESH_LIMIT_S, cwd=root,
        env=dict(os.environ, PYTHONPATH=root))
    if rc != 0:
        print(log[-6000:], flush=True)
        raise RuntimeError(f"14 (b): the two-pass world exited {rc}")
    rec["b"] = {"equal_one_rank": file_bytes(out_b) == file_bytes(
        os.path.join(tmp, "gp_rate.mp4")), "torchrun_s":
        time.perf_counter() - t1}
    ranks_c, secs_c = torchrun_ranks(tmp, "mesh_c", MESH_RANKS, "tiles", [])
    rec["c"] = dict(ranks_c[0], torchrun_s=secs_c)
    cards = CARDS_AT_START
    k = min(NCCL_MAX, len(cards))
    if k < 2:
        why = (f"{len(cards)} card(s) visible when the run started; NCCL "
               f"takes a card a rank, so a world needs two")
        print(f"phase 14 (d): ran no NCCL world: {why}", flush=True)
        rec["d"] = {"ran": False, "why": why}
    else:
        env = {"CUDA_VISIBLE_DEVICES": ",".join(cards[:k])}
        out_d = os.path.join(tmp, "gp_nccl.mp4")
        rec["d"] = mesh_job(tmp, "mesh_d", k, pj.letterbox_argv(src, out_d)
                            + ["--gop-parallel", str(GP_N)], out_d, one, env)
        ranks_t, secs_t = torchrun_ranks(tmp, "mesh_d_tiles", k, "tiles",
                                         [], env)
        rec["d"].update(ran=True, tiles=dict(ranks_t[0], torchrun_s=secs_t))
    rec["seconds"] = time.perf_counter() - t0
    print(json.dumps(rec), flush=True)
    print(f"phase 14 ({label}): {rec['seconds']:.1f} s", flush=True)
    checks = [rec["one"]["equal_one_rank"], rec["one"]["backend"] is None,
              rec["a"]["equal_one_rank"], rec["a"]["backend"] == "gloo",
              rec["a"]["resample_launches"] == [N_FRAMES]
              + [0] * (MESH_RANKS - 1),
              rec["b"]["equal_one_rank"], rec["c"]["equal_untiled"],
              rec["c"]["backend"] == "gloo"]
    if rec["d"]["ran"]:
        checks += [rec["d"]["equal_one_rank"], rec["d"]["backend"] == "nccl",
                   rec["d"]["tiles"]["equal_untiled"]]
    if not all(checks):
        raise RuntimeError(f"14: a check failed: {checks}")
    return rec


def ldconfig_sonames() -> list:
    """15 (a): the sonames of CATALOG_LIBS that ``ldconfig -p`` lists."""
    try:
        out = subprocess.run(["ldconfig", "-p"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired) as e:
        return [f"ldconfig -p failed: {e!r}"]
    return sorted({ln.split()[0] for ln in out.splitlines()
                   if ln.strip().startswith(CATALOG_LIBS)})


@contextlib.contextmanager
def pipeline_starts():
    """Counts the job pipelines started inside the block: a refused job
    starts none, so it reads and decodes no frame."""
    from handbrake_tpu_torch.core import pipeline
    runs = [0]
    run = pipeline.Pipeline.run

    def counted(self, *a, **k):
        runs[0] += 1
        return run(self, *a, **k)
    pipeline.Pipeline.run = counted
    try:
        yield runs
    finally:
        pipeline.Pipeline.run = run


def refusal(name, drive, out, missing, step="15 (b)") -> dict:
    """15 (b), 16: `drive` (a CLI run or a do_job) must refuse with a
    message that holds `missing` (what is missing, or the setting
    refused), start no pipeline and leave no `out`."""
    import io
    err = io.StringIO()
    t0 = time.perf_counter()
    with pipeline_starts() as runs, contextlib.redirect_stderr(err):
        try:
            rc = drive()
            msg = err.getvalue().strip().splitlines()[-1:] or [""]
            msg = msg[0]
        except Exception as e:  # noqa: BLE001 — the stated refusal
            rc, msg = type(e).__name__, str(e)
    rec = {"job": name, "refuse_s": time.perf_counter() - t0,
           "result": rc, "message": msg, "pipelines": runs[0],
           "output_exists": os.path.exists(out)}
    rec["ok"] = (rc not in (0, None) and missing in msg
                 and runs[0] == 0 and not rec["output_exists"])
    print(f"{step} {name}: {'refused' if rec['ok'] else 'NOT REFUSED'} "
          f"in {rec['refuse_s'] * 1e3:.1f} ms: {msg}", flush=True)
    return rec


def catalog_refusals(tmp, missing) -> list:
    """15 (b): each catalog job on a machine without the library."""
    from handbrake_tpu_torch import work
    from handbrake_tpu_torch.cli.__main__ import main as cli_main
    from handbrake_tpu_torch.job.schema import AudioJobTrack, Job
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "data", "torch_sources")
    recs = []
    out = os.path.join(tmp, "webm_refused.webm")
    recs.append(refusal("WebM 1080p30 preset (CLI)", lambda: cli_main(
        ["-i", os.path.join(tmp, "gp.y4m"), "-o", out, "-Z",
         "WebM 1080p30"]), out, missing))
    out = os.path.join(tmp, "opus_refused.mkv")
    recs.append(refusal("-a 1 -E opus on job 8's source (CLI)",
                        lambda: cli_main(
                            ["-i", os.path.join(tmp, "av.mp4"), "-o", out,
                             "-e", "h264", "-q", "28", "-a", "1", "-E",
                             "opus"]), out, missing))
    for name, fn in CATALOG_SOURCES.items():
        out = os.path.join(tmp, f"{name}_refused.mp4")
        job = Job(path=os.path.join(data, fn), file=out, mux="mp4",
                  vcodec="h264", quality=28.0, encoder_profile="high")
        job.audio = [AudioJobTrack(track=0, encoder="aac")] \
            if name == "eac3" else []
        recs.append(refusal(f"{fn} to H.264 (do_job)", lambda job=job:
                            work.do_job(job),
                            out, missing))
    return recs


def catalog_jobs(tmp) -> dict:
    """15 (c): the WebM 1080p30 job on WEBM_N frames of the letterboxed
    y4m and the MPEG-4 AVI to H.264, where the library is present."""
    import torch
    from handbrake_tpu_torch import work
    from handbrake_tpu_torch.cli.__main__ import main as cli_main
    from handbrake_tpu_torch.codecs import avcodec
    from handbrake_tpu_torch.codecs.h264 import deblock_cuda
    from handbrake_tpu_torch.codecs.registry import create_video_decoder
    from handbrake_tpu_torch.core.buffer import Buffer
    from handbrake_tpu_torch.filters import resample_cuda
    from handbrake_tpu_torch.job.schema import Job
    from handbrake_tpu_torch.sources.probe import open_source
    rec = {}
    out = os.path.join(tmp, "webm.webm")
    host = [0.0]
    push = work._AVVideoEncoderAdapter.push_display_frame

    def timed(self, *a, **k):
        t = time.perf_counter()
        try:
            return push(self, *a, **k)
        finally:
            host[0] += time.perf_counter() - t
    work._AVVideoEncoderAdapter.push_display_frame = timed
    try:
        reset_counts()
        t0 = time.perf_counter()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            rc = cli_main(["-i", os.path.join(tmp, "gp.y4m"), "-o", out,
                           "-Z", "WebM 1080p30", "--stop-at",
                           f"frame:{WEBM_N}"])
        job_s = time.perf_counter() - t0
    finally:
        work._AVVideoEncoderAdapter.push_display_frame = push
    if rc != 0:
        raise RuntimeError(f"15 (c): the WebM job exited {rc}")
    src = open_source(out)
    try:
        ti = src.tracks[0]
        dec = avcodec.AVVideoDecoder("vp9", bytes(ti.extradata or b""))
        frames = [f for _t, b in src.packets() if _t == 0
                  for f in dec.decode(b.data, b.pts)] + dec.flush()
    finally:
        src.close()
    rec["webm"] = {"frames": len(frames), "codec": ti.codec,
                   "size": [ti.width, ti.height],
                   "resample_launches": resample_cuda.launches,
                   "fps": WEBM_N / job_s, "job_s": job_s,
                   "libvpx_host_ms_a_frame": host[0] * 1e3 / WEBM_N,
                   "busy_share": device_busy_ms(prof) / (job_s * 1e3)}
    avi = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                       "data", "torch_sources",
                       CATALOG_SOURCES["mpeg4_bframes"])
    out = os.path.join(tmp, "mpeg4.mp4")
    reset_counts()
    t0 = time.perf_counter()
    work.do_job(Job(path=avi, file=out, mux="mp4", vcodec="h264",
                    quality=28.0, encoder_profile="high"))
    job_s = time.perf_counter() - t0
    src = open_source(out)
    try:
        dec = create_video_decoder("h264", src.tracks[0].extradata)
        n = sum(len(dec.feed(Buffer(data=b.data, pts=b.pts)))
                for _t, b in src.packets())
    finally:
        src.close()
    rec["mpeg4"] = {"frames": n, "deblock264_launches": deblock_cuda.launches,
                    "fps": 12 / job_s, "job_s": job_s}
    ok = (rec["webm"]["frames"] == WEBM_N and rec["webm"]["codec"] == "vp9"
          and rec["mpeg4"]["frames"] == 12
          and rec["webm"]["resample_launches"] == WEBM_N
          and rec["mpeg4"]["deblock264_launches"] > 0)
    if not ok:
        raise RuntimeError(f"15 (c): a check failed: {rec}")
    return rec


def phase_catalog(tmp, label) -> dict:
    """15: the libavcodec catalog: (a) the machine's libraries; (b) the
    refusals where the library is missing, or (c) the jobs where it is
    there."""
    from handbrake_tpu_torch.codecs import avcodec
    t0 = time.perf_counter()
    rec = {"phase": "15", "card": label, "ldconfig": ldconfig_sonames(),
           "available": avcodec.available(), "missing": avcodec.missing()}
    print(f"15 (a): ldconfig lists {rec['ldconfig'] or 'none of them'}; "
          f"the binding: "
          f"{'loads libavcodec' if rec['available'] else rec['missing']}",
          flush=True)
    if rec["available"]:
        rec["jobs"] = catalog_jobs(tmp)
    else:
        rec["refusals"] = catalog_refusals(tmp, rec["missing"])
        if not all(r["ok"] for r in rec["refusals"]):
            raise RuntimeError("15 (b): a catalog job did not refuse")
    rec["seconds"] = time.perf_counter() - t0
    print(json.dumps(rec), flush=True)
    print(f"phase 15 ({label}): {rec['seconds']:.1f} s", flush=True)
    return rec


@contextlib.contextmanager
def scans():
    """Counts the scans that ``Handle.scan`` starts inside the block."""
    from handbrake_tpu_torch import hb
    n = [0]
    scan = hb.Handle.scan

    def counted(self, *a, **k):
        n[0] += 1
        return scan(self, *a, **k)
    hb.Handle.scan = counted
    try:
        yield n
    finally:
        hb.Handle.scan = scan


@contextlib.contextmanager
def library_hidden(tmp):
    """The binding as on a machine without libavcodec: where the library
    is there, it is looked for in an empty directory, with a fresh probe
    state, inside the block."""
    from handbrake_tpu_torch.codecs import avcodec
    if not avcodec.available():
        yield
        return
    empty = os.path.join(tmp, "no_libavcodec")
    os.makedirs(empty, exist_ok=True)
    saved = avcodec._LIBDIR, avcodec._state
    avcodec._LIBDIR, avcodec._state = empty, {}
    try:
        yield
    finally:
        avcodec._LIBDIR, avcodec._state = saved


def phase_refusals(tmp, label, bf) -> dict:
    """16: the settings and codecs that a job refuses before it starts:
    (a) a 1080p --bframes job through the CLI with -x cabac=1; (b) phase
    10's B-frame job logged that its profile's CABAC and 8x8 transform
    are not applied; (c) with libavcodec missing, the CLI's WebM preset
    and -E opus jobs refuse before their scan, each within
    REFUSE_LIMIT_S."""
    from handbrake_tpu_torch.cli.__main__ import main as cli_main
    from handbrake_tpu_torch.codecs import avcodec
    t0 = time.perf_counter()
    rec = {"phase": "16", "card": label}
    out = os.path.join(tmp, "bframes_cabac.mp4")
    rec["a"] = refusal("--bframes 3 -x cabac=1 on 13's 1080p y4m (CLI)",
                       lambda: cli_main(["-i", os.path.join(tmp, "hv3.y4m"),
                                         "-o", out, "-e", "h264", "-q",
                                         str(B_Q), "--bframes",
                                         str(B_FRAMES), "-x", "cabac=1"]),
                       out, "cannot take cabac=1", step="16 (a)")
    rec["b"] = {"log_line": bf["log_line"]}
    print(f"16 (b): phase 10's --bframes job logged: {bf['log_line']}",
          flush=True)
    with library_hidden(tmp):
        missing = avcodec.missing()
        rec["c"] = []
        for name, argv, out in (
                ("WebM 1080p30 preset (CLI)", ["-Z", "WebM 1080p30"],
                 os.path.join(tmp, "webm_early.webm")),
                ("-a 1 -E opus on job 8's source (CLI)",
                 ["-e", "h264", "-q", "28", "-a", "1", "-E", "opus"],
                 os.path.join(tmp, "opus_early.mkv"))):
            src = os.path.join(tmp, "av.mp4" if "-E" in argv else "gp.y4m")
            with scans() as n:
                r = refusal(name, lambda: cli_main(
                    ["-i", src, "-o", out, *argv]), out, missing,
                    step="16 (c)")
            r["scans"] = n[0]
            r["ok"] = r["ok"] and n[0] == 0 \
                and r["refuse_s"] < REFUSE_LIMIT_S
            rec["c"].append(r)
    rec["seconds"] = time.perf_counter() - t0
    print(json.dumps(rec), flush=True)
    print(f"phase 16 ({label}): {rec['seconds']:.1f} s", flush=True)
    if not (rec["a"]["ok"] and all(r["ok"] for r in rec["c"])):
        raise RuntimeError(f"16: a check failed: {rec}")
    return rec


def pal_dvd_folder(root):
    """17 (a): a VIDEO_TS folder over two VOBs holding the first PAL_N
    pictures (in stream order) of the 16:9 PAL MPEG-2 fixture (720x576,
    aspect_ratio_information 3, frame_rate_code 3), its IFO saying PAL
    16:9 with 25 fps playback times.  Returns (folder, pictures)."""
    from handbrake_tpu_torch.tools import source_builders as B
    es = b"".join(B.split_pictures(B.fixture("mpeg2_720x576_16x9.m2v"))
                  [:PAL_N])
    units = B.video_units(es, DVD_T0, PAL_TICKS)
    half = len(units) * PAL_TICKS / 90000 / 2
    B.write_dvd(root, B.build_ps(units), 2, [half, half],
                B.vts_video_attr("PAL", (16, 9)), fps=25)
    return root, len(units)


def sar_h264_source(path):
    """17 (b): LOOSE_N make_clip frames at 1440x1080 coded on the card by
    the port's encoder (High profile, VUI aspect LOOSE_SAR, 25 fps) as an
    annex-B stream."""
    from handbrake_tpu_torch.codecs.h264.encoder import (EncoderConfig,
                                                         H264Encoder)
    from handbrake_tpu_torch.utils.synth import make_clip
    enc = H264Encoder(EncoderConfig(
        width=1440, height=1080, qp=QP, gop=LOOSE_N, cabac=True,
        deblock=True, transform8x8=True, fps=(25, 1), sar=LOOSE_SAR))
    with open(path, "wb") as f:
        for y, u, v in make_clip(1440, 1080, LOOSE_N, seed=31):
            f.write(enc.encode_frame(y, u, v))
    return path


def par_y4m(path):
    """17 (c): Y4M_PAR_N make_clip frames at 720x480 with ``A32:27``."""
    from handbrake_tpu_torch.utils.synth import make_clip
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W720 H480 F30000:1001 Ip A{Y4M_PAR[0]}:"
                f"{Y4M_PAR[1]} C420\n".encode())
        for y, u, v in make_clip(720, 480, Y4M_PAR_N, seed=33):
            f.write(b"FRAME\n" + y.tobytes() + u.tobytes() + v.tobytes())
    return path


def mkv_video(path):
    """The first track of an mkv (TrackInfo) and its Video element's
    unsigned children by id (PixelWidth 0xB0, DisplayWidth 0x54B0, ...)."""
    from handbrake_tpu_torch.sources import mkv as M

    class Demuxer(M.MKVDemuxer):
        def _parse_tracks(self, data):
            self.raw_tracks = data
            super()._parse_tracks(data)

    d = Demuxer(path)
    d.close()
    entry = dict(M._children(next(p for e, p in M._children(d.raw_tracks)
                                  if e == 0xAE)))
    return d.tracks[0], {e: M._uint(p) for e, p in
                         M._children(entry.get(0xE0, b""))}


def video_vui(path):
    """(track, its SPS's VUI {"sar", "timing"}, sample durations) of an
    mp4's or mkv's first track."""
    from handbrake_tpu_torch.codecs.vui import stream_vui
    from handbrake_tpu_torch.sources.mp4 import MP4Demuxer
    if path.endswith(".mkv"):
        ti, _ = mkv_video(path)
        return ti, stream_vui(ti.codec, ti.extradata), None
    d = MP4Demuxer(path)
    try:
        ti = d.tracks[0]
        durs = [d.read_sample(0, i).duration for i in range(d.n_samples(0))]
    finally:
        d.close()
    return ti, stream_vui(ti.codec, ti.extradata), durs


def same_file(a, b) -> bool:
    with open(a, "rb") as f, open(b, "rb") as g:
        return f.read() == g.read()


def phase_anamorphic(tmp, label):
    """17: anamorphic jobs on the card, each beside the same CLI job on
    the CPU (a process of its own, started first), one JSON line a part
    with the card's name and power limit.  Its helper processes are
    stopped when it ends, whether it passes or fails."""
    try:
        return anamorphic_parts(tmp, label)
    finally:
        for p in PROCS:
            if p.poll() is None:
                p.kill()
            p.wait()


def anamorphic_parts(tmp, label):
    from handbrake_tpu_torch.sources.probe import open_source
    t0 = time.perf_counter()
    dvd, n_pal = pal_dvd_folder(os.path.join(tmp, "pal_dvd"))
    loose_src = sar_h264_source(os.path.join(tmp, "sar43.264"))
    y4m = par_y4m(os.path.join(tmp, "par.y4m"))
    sources_s = time.perf_counter() - t0
    jobs = {
        "a": (dvd, "pal.mp4", ["-e", "h264", "-q", "28", "--encoder-profile",
                               "high", "--previews", str(PAR_PREVIEWS)]),
        "b": (loose_src, "loose.mkv", [
            "-e", "h264", "-q", "28", "--encoder-profile", "high",
            "--loose-anamorphic", "--maxWidth", str(LOOSE_MAX_W), "-f",
            "mkv", "--previews", str(PAR_PREVIEWS)]),
        "c": (y4m, "par.mkv", ["-e", "x265", "-q", "28", "-f", "mkv"])}
    cpu = {k: start_process(tmp, f"par_{k}_cpu", [
        "-m", "handbrake_tpu_torch.cli", "-i", src, "-o",
        os.path.join(tmp, "cpu_" + out), *argv, "--device", "cpu"],
        threads=PAL_CPU_THREADS if k == "a" else 2)
        for k, (src, out, argv) in jobs.items()}
    rec = {"phase": "17", "card": label, "sources_s": sources_s}
    card = {}
    for k, (src, out, argv) in jobs.items():
        t1 = time.perf_counter()
        secs, dev_ms, db, rs, spy = disc_job(
            "cli", ["-i", src, "-o", os.path.join(tmp, out), *argv])
        card[k] = {"do_job_s": secs, "cli_s": time.perf_counter() - t1,
                   "device_ms": dev_ms, "deblock264_launches": db,
                   "resample_launches": rs, "p_frames": spy.p_frames(),
                   "job_par": [spy.job.par_num, spy.job.par_den],
                   "anamorphic_mode": spy.job.anamorphic_mode}
    for k in jobs:
        finish_process(cpu[k])
        # when this phase had the CPU run's file (it may have ended sooner)
        card[k]["cpu_run_done_s"] = time.perf_counter() - t0
        card[k]["equal_cpu_file"] = same_file(
            os.path.join(tmp, jobs[k][1]), os.path.join(tmp, "cpu_"
                                                        + jobs[k][1]))
    # (a): the title's aspect and rate, the SPS's and the pasp's aspect,
    # the VUI's and the samples' 25 fps, every picture a sample
    src = open_source(dvd)
    title = src.tracks[0]
    src.close()
    ti, vui, durs = video_vui(os.path.join(tmp, "pal.mp4"))
    nu, ts = vui["timing"] or (0, 0)
    a = dict(card["a"], pictures=n_pal, samples=len(durs),
             title_par=[title.par_num, title.par_den],
             title_rate=list(title.frame_rate), size=[ti.width, ti.height],
             pasp=[ti.par_num, ti.par_den], sps_sar=vui["sar"],
             vui_fps=ts / (2 * nu) if nu else None,
             sample_durations=sorted(set(durs)))
    a["fps"] = n_pal / a["do_job_s"]
    a["ok"] = (tuple(a["title_par"]) == PAL_PAR
               and tuple(a["title_rate"]) == (25, 1)
               and tuple(a["job_par"]) == PAL_PAR
               and tuple(a["pasp"]) == PAL_PAR
               and tuple(a["sps_sar"] or ()) == PAL_PAR
               and a["vui_fps"] == 25 and a["sample_durations"] == [PAL_TICKS]
               and a["samples"] == n_pal and a["equal_cpu_file"]
               and a["deblock264_launches"] >= a["p_frames"] > 0)
    rec["a"] = a
    print(json.dumps(dict(a, part="17a", card=label)), flush=True)
    print(f"17 (a): the 16:9 PAL DVD job launched deblock264 "
          f"{a['deblock264_launches']} times for {a['p_frames']} P frames",
          flush=True)
    # (b): the loose job scales on the card; its display size is 16:9
    ti, vui, _ = video_vui(os.path.join(tmp, "loose.mkv"))
    _, video = mkv_video(os.path.join(tmp, "loose.mkv"))
    dw, dh = video.get(0x54B0), video.get(0x54BA)
    b = dict(card["b"], frames=LOOSE_N, size=[video[0xB0], video[0xBA]],
             display=[dw, dh], sps_sar=vui["sar"])
    b["ok"] = (bool(dw and dh) and abs(dw * 9 - dh * 16) <= 16
               and b["resample_launches"] == LOOSE_N
               and b["sps_sar"] == tuple(b["job_par"])
               and b["equal_cpu_file"])
    rec["b"] = b
    print(json.dumps(dict(b, part="17b", card=label)), flush=True)
    # (c): the HEVC VUI's aspect and the mkv's display size
    ti, vui, _ = video_vui(os.path.join(tmp, "par.mkv"))
    _, video = mkv_video(os.path.join(tmp, "par.mkv"))
    c = dict(card["c"], frames=Y4M_PAR_N, sps_sar=vui["sar"],
             display=[video.get(0x54B0), video.get(0x54BA)])
    c["ok"] = (tuple(c["sps_sar"] or ()) == Y4M_PAR
               and c["display"] == [(720 * Y4M_PAR[0] * 2 + Y4M_PAR[1])
                                    // (2 * Y4M_PAR[1]), 480]
               and c["equal_cpu_file"])
    rec["c"] = c
    print(json.dumps(dict(c, part="17c", card=label)), flush=True)
    rec["seconds"] = time.perf_counter() - t0
    print(f"phase 17 ({label}): {rec['seconds']:.1f} s", flush=True)
    bad = [k for k in "abc" if not rec[k]["ok"]]
    if bad:
        raise RuntimeError(f"17: the checks of {bad} failed: "
                           f"{json.dumps({k: rec[k] for k in bad})}")
    return rec


def copy_dvd_folder(root):
    """18: a VIDEO_TS folder over two VOBs: the first COPY_DVD_N pictures
    of the 720x480 MPEG-2 fixture; audio stream 1 AC-3 3/2+LFE at 448
    kb/s from the port's encoder (substream 0x80), stream 2 DTS 5.1 core
    frames built from the spec's header, each payload of a byte of its
    own (0x89: no machine here decodes DTS, so it is only copied), both
    laid into
    2048-byte sectors as an authoring tool lays them (frames across PES
    packets, a PTS where a frame begins: ``sector_packs``), stream 3 DVD
    LPCM stereo (0xA2); the IFO's audio attributes eng, eng, fre (as ISO
    639-1 codes).  Returns (folder, AC-3 frames, DTS frames, pictures)."""
    from handbrake_tpu_torch.audio.ac3enc import Ac3Encoder
    from handbrake_tpu_torch.tools import source_builders as B
    es = b"".join(B.split_pictures(B.fixture("mpeg2_720x480.m2v"))
                  [:COPY_DVD_N])
    units = B.video_units(es, DVD_T0, FRAME_TICKS)
    n = len(units)
    secs = n * FRAME_TICKS / 90000
    ac3 = Ac3Encoder(48000, 6, COPY_AC3_BPS)
    ac3_frames = ac3.encode(disc_tone(6, secs, 31)) + ac3.flush()
    packs = B.sector_packs(0xBD, ac3_frames, [
        DVD_T0 + k * 2880 for k in range(len(ac3_frames))], 0x80)
    dts = [B.dts_core_frame(size=DTS_FRAME_BYTES, fill=k % 250 + 1)
           for k in range(int(secs * 90000 / DTS_FRAME_TICKS) + 1)]
    packs += B.sector_packs(0xBD, dts, [DVD_T0 + k * DTS_FRAME_TICKS
                                        for k in range(len(dts))], 0x89)
    lp = disc_tone(2, secs, 32)
    units += [(DVD_T0 + k * 900, 0xBD,
               B.s16be_lpcm(lp[k * 480:(k + 1) * 480]),
               functools.partial(B.lpcm_sub, stream=2), DVD_T0 + k * 900)
              for k in range(len(lp) // 480)]
    half = secs / 2
    B.write_dvd(root, B.build_ps(units, packs), 2, [half, half],
                audio_attrs=[B.vts_audio_attr(*a) for a in COPY_DVD_ATTRS])
    return root, ac3_frames, dts, n


def stts_durations(path) -> list:
    """Each mp4 track's sample durations in its own timescale (its
    ``stts`` entries, in track order)."""
    with open(path, "rb") as f:
        data = f.read()
    out, i = [], data.find(b"stts")
    while i > 0:
        durs = []
        for k in range(int.from_bytes(data[i + 8:i + 12], "big")):
            e = data[i + 12 + 8 * k:i + 20 + 8 * k]
            durs += [int.from_bytes(e[4:], "big")] * int.from_bytes(
                e[:4], "big")
        out.append(durs)
        i = data.find(b"stts", i + 4)
    return out


def phase_audio_copy(tmp, label):
    """18: a DVD with AC-3, DTS and LPCM tracks on the card, one JSON line
    a part with the card's name and power limit.  Its helper process is
    stopped when it ends, whether it passes or fails."""
    try:
        return audio_copy_parts(tmp, label)
    finally:
        for p in PROCS:
            if p.poll() is None:
                p.kill()
            p.wait()


def audio_copy_parts(tmp, label):
    from handbrake_tpu_torch.audio.aacdec import AACDecoder
    from handbrake_tpu_torch.audio.ac3dec import read_bsi
    from handbrake_tpu_torch.audio.frames import read_frame
    from handbrake_tpu_torch.cli.__main__ import main as cli_main
    from handbrake_tpu_torch.mux.mp4 import dac3
    from handbrake_tpu_torch.scan import scan
    t0 = time.perf_counter()
    root, ac3_frames, dts_frames, n = copy_dvd_folder(
        os.path.join(tmp, "copy_dvd"))
    preset = os.path.join(tmp, "copy_preset.json")
    with open(preset, "w") as f:
        json.dump(COPY_PRESET, f)
    (title,) = scan(root, preview_count=1)
    langs = [(a.codec, a.channels, a.language) for a in title.audio]
    argv_a = ["-i", root, "--preset-import-file", preset, "--previews", "1"]
    out_a, cpu_a = (os.path.join(tmp, f) for f in ("copy.mp4",
                                                    "copy_cpu.mp4"))
    cpu = start_process(tmp, "copy_cpu", [
        "-m", "handbrake_tpu_torch.cli", *argv_a, "-o", cpu_a, "--device",
        "cpu"], threads=COPY_CPU_THREADS)
    rec = {"phase": "18", "card": label, "pictures": n,
           "title_audio": langs, "sources_s": time.perf_counter() - t0}
    # (a) the preset job: AAC stereo and the AC-3 copy, both of track 1
    t1 = time.perf_counter()
    secs, dev_ms, db, rs, spy = disc_job("cli", [*argv_a, "-o", out_a])
    cli_s = time.perf_counter() - t1
    tracks, pk = read_tracks(out_a)
    audio = [(t.codec, t.sample_rate, t.channels) for t in tracks[1:]]
    aac = np.concatenate([AACDecoder(tracks[1].extradata).decode_frame(p)
                          for _, p in pk[1]]) if len(tracks) > 2 else None
    finish_process(cpu)
    copied = [p for _, p in pk.get(2, [])]
    a = {"do_job_s": secs, "cli_s": cli_s,
         "cpu_run_done_s": time.perf_counter() - t0, "device_ms": dev_ms,
         "deblock264_launches": db,
         "resample_launches": rs, "p_frames": spy.p_frames(),
         "job_audio": [(x.track + 1, x.encoder) for x in spy.job.audio],
         "audio_tracks": audio, "samples": len(pk.get(0, [])),
         "copy_equal_source": copied == ac3_frames,
         "copy_samples_whole_frames": sum(
             (read_frame("ac3", p) or (0,))[0] == len(p) for p in copied),
         "copy_sample_durations": sorted(set(stts_durations(out_a)[2]))
         if len(tracks) > 2 else None,
         "dac3": bytes(tracks[2].extradata).hex() if len(tracks) > 2
         else None, "stream_dac3": dac3(read_bsi(ac3_frames[0])).hex(),
         "aac_samples": int(aac.shape[0]) if aac is not None else 0,
         "aac_peak": float(np.abs(aac).max()) if aac is not None else 0.0,
         "equal_cpu_file": same_file(out_a, cpu_a)}
    a["ok"] = (a["job_audio"] == [(1, "aac"), (1, "copy")]
               and audio == [("aac", 48000, 2), ("ac3", 48000, 6)]
               and a["samples"] == n and a["copy_equal_source"]
               and a["copy_samples_whole_frames"] == len(ac3_frames)
               and a["copy_sample_durations"] == [1536]
               and a["dac3"] == a["stream_dac3"]
               and abs(a["aac_samples"] - 1536 * len(ac3_frames)) <= 2048
               and bool(np.isfinite(aac).all()) and a["aac_peak"] > 0.05
               and a["equal_cpu_file"]
               and a["deblock264_launches"] >= a["p_frames"] > 0)
    rec["a"] = a
    print(json.dumps(dict(a, part="18a", card=label)), flush=True)
    print(f"18 (a): the DVD preset job launched deblock264 "
          f"{a['deblock264_launches']} times for {a['p_frames']} P frames, "
          f"the resample kernel {a['resample_launches']} times", flush=True)
    # (b) copies of the AC-3 and DTS tracks, the LPCM track to AC-3
    out_b = os.path.join(tmp, "copy.mkv")
    t1 = time.perf_counter()
    with log_lines() as lines:
        secs, dev_ms, db, rs, spy = disc_job("cli", [
            "-i", root, "-o", out_b, "-e", "h264", "-q", "28",
            "--encoder-profile", "high", "--previews", "1", "-a", "1,2,3",
            "-E", "copy:ac3,copy:dts,copy:ac3"])
    tracks, pk = read_tracks(out_b)
    with open(out_b, "rb") as f:
        a_dts = f.read().count(b"A_DTS")
    resolved = [ln.split("hbtpu: ", 1)[-1] for ln in lines
                if "audio: track" in ln]
    b = {"do_job_s": secs, "cli_s": time.perf_counter() - t1,
         "device_ms": dev_ms, "deblock264_launches": db,
         "resample_launches": rs,
         "audio_tracks": [(t.codec, t.sample_rate, t.channels)
                          for t in tracks[1:]],
         "ac3_copy_equal": [p for _, p in pk.get(1, [])] == ac3_frames,
         "dts_copy_equal": [p for _, p in pk.get(2, [])] == dts_frames,
         "dts_blocks": len(pk.get(2, [])),
         "dts_blocks_whole_frames": sum(
             (read_frame("dts", p) or (0,))[0] == len(p) == DTS_FRAME_BYTES
             for _, p in pk.get(2, [])),
         "lpcm_ac3_frames": len(pk.get(3, [])), "resolutions": resolved,
         "a_dts_codec_ids": a_dts}
    b["ok"] = ([t[0] for t in b["audio_tracks"]] == ["ac3", "dts", "ac3"]
               and b["audio_tracks"][:2] == [("ac3", 48000, 6),
                                             ("dts", 48000, 6)]
               and a_dts == 1
               and b["ac3_copy_equal"] and b["dts_copy_equal"]
               and b["dts_blocks_whole_frames"] == b["dts_blocks"]
               == len(dts_frames)
               and b["lpcm_ac3_frames"] >= len(ac3_frames) - 1
               and any("(lpcm), copy:ac3: ac3 (the track is lpcm" in r
                       for r in resolved) and db > 0)
    rec["b"] = b
    print(json.dumps(dict(b, part="18b", card=label)), flush=True)
    # (c) copy of the DTS track with the default preset's mask (AAC,
    # AC-3): the AAC fallback needs a DTS decoder, which libavcodec gives
    # and this machine lacks (hidden where it is there)
    out_c = os.path.join(tmp, "dts_fallback.mp4")
    t1 = time.perf_counter()
    with library_hidden(tmp), log_lines() as lines:
        rc = cli_main(["-i", root, "-o", out_c, "-e", "h264", "-q", "28",
                       "--previews", "1", "-a", "2", "-E", "copy"])
    c = {"cli_s": time.perf_counter() - t1, "rc": rc,
         "file_exists": os.path.exists(out_c),
         "resolution": next((ln.split("hbtpu: ", 1)[-1] for ln in lines
                             if "audio: track" in ln), None)}
    c["ok"] = (rc != 0 and not c["file_exists"]
               and "(dts), copy: aac (dts is not in the copy mask"
               in (c["resolution"] or ""))
    rec["c"] = c
    print(json.dumps(dict(c, part="18c", card=label)), flush=True)
    # (d) resume of the DVD job with sound beside the same job without
    d = {sound: resume_dvd(root, tmp, sound) for sound in ("aac_copy",
                                                           "none")}
    d["ok"] = all(r["equal_to_uninterrupted"] and not r["journal_left"]
                  and r["frames_coded_on_resume"] == n - COPY_RESUME_DONE
                  for r in d.values())
    rec["d"] = d
    print(json.dumps(dict(d, part="18d", card=label)), flush=True)
    rec["seconds"] = time.perf_counter() - t0
    print(f"phase 18 ({label}): {rec['seconds']:.1f} s", flush=True)
    bad = [k for k in "abcd" if not rec[k]["ok"]]
    if bad:
        raise RuntimeError(f"18: the checks of {bad} failed: "
                           f"{json.dumps({k: rec[k] for k in bad})}")
    return rec


def resume_dvd(root, tmp, sound):
    """18 (d): the DVD H.264 High to mp4 at keyint COPY_RESUME_KEYINT,
    with AAC beside the AC-3 copy of track 1 (``sound`` "aac_copy") or no
    sound ("none"), checkpointed, its journal cut after the first
    COPY_RESUME_DONE frames and resumed: both runs' seconds, the frames
    each decoded and coded, and whether the resumed file equals the
    uninterrupted one."""
    import torch

    from handbrake_tpu_torch import checkpoint, work
    from handbrake_tpu_torch.job import schema as S
    out = os.path.join(tmp, f"resume_{sound}.mp4")

    def job(**kw):
        j = S.Job(path=root, file=out, mux="mp4", vcodec="h264",
                  quality=28.0, encoder_profile="high",
                  encoder_options=f"keyint={COPY_RESUME_KEYINT}", **kw)
        if sound == "aac_copy":
            j.audio = [S.AudioJobTrack(track=0, encoder="aac", bitrate=160),
                       S.AudioJobTrack(track=0, encoder="copy:ac3")]
        return j
    with kept_journal():
        t1 = time.perf_counter()
        full_stats = work.do_job(job(checkpoint=True))
        torch.cuda.synchronize()
        full_s = time.perf_counter() - t1
    full = file_bytes(out)
    data = file_bytes(out + ".ckpt")
    marks = [end for tag, _s, end in checkpoint.spans(data) if tag == "g"]
    with open(out + ".ckpt", "wb") as f:
        f.write(data[:marks[COPY_RESUME_DONE // COPY_RESUME_KEYINT - 1]])
    os.unlink(out)
    t1 = time.perf_counter()
    stats = work.do_job(job(resume=True))
    torch.cuda.synchronize()
    return {"full_s": full_s, "resume_s": time.perf_counter() - t1,
            "frames_decoded_full": full_stats["frames_decoded"],
            "frames_decoded_on_resume": stats["frames_decoded"],
            "frames_coded_on_resume": stats["frames_out"],
            "equal_to_uninterrupted": file_bytes(out) == full,
            "journal_left": os.path.exists(out + ".ckpt")}


def cut_journal(path, gops):
    """Cut `path`.ckpt after its `gops`-th GOP marker and delete `path`,
    as a kill after that GOP would leave them; the frames it keeps."""
    from handbrake_tpu_torch import checkpoint
    data = file_bytes(path + ".ckpt")
    marks = [(s, end) for tag, s, end in checkpoint.spans(data)
             if tag == "g"]
    s, end = marks[gops - 1]
    with open(path + ".ckpt", "wb") as f:
        f.write(data[:end])
    os.unlink(path)
    return checkpoint._get(data[s + checkpoint._HDR.size:end], 0)[0][0]


def resumed(label, part, job, gops):
    """Run `job` (a callable of checkpoint/resume keywords) checkpointed,
    cut its journal after `gops` GOPs and resume it on the card: both
    runs' seconds, the frames each decoded and coded, the kernels'
    launches in each, the resume path and its log line, and whether the
    resumed file equals the uninterrupted one."""
    import torch

    from handbrake_tpu_torch import work
    from handbrake_tpu_torch.codecs.h264 import deblock_cuda
    from handbrake_tpu_torch.filters import hqdn3d_cuda, resample_cuda
    from handbrake_tpu_torch.tools import profile_job as pj
    runs = {}
    for kind in ("full", "resume"):
        kw = {"checkpoint": True} if kind == "full" else {"resume": True}
        with kept_journal(), log_lines() as lines, pj.JobSpy() as spy:
            reset_counts()
            t0 = time.perf_counter()
            stats = work.do_job(job(**kw))
            torch.cuda.synchronize()
            runs[kind] = {
                "s": time.perf_counter() - t0,
                "frames_decoded": stats["frames_decoded"],
                "video_packets_skipped": stats["video_packets_skipped"],
                "frames_coded": stats["frames_out"],
                "deblock264_launches": deblock_cuda.launches,
                "hqdn3d_launches": hqdn3d_cuda.launches,
                "resample_launches": resample_cuda.launches,
                "p_frames": spy.p_frames(), "redos": spy.enc.n_redo,
                "path": stats["resume"],
                "log": next((ln.split("hbtpu: ", 1)[-1] for ln in lines
                             if "resume:" in ln), None)}
        if kind == "full":
            out = job().file
            full = file_bytes(out)
            runs["done"] = cut_journal(out, gops)
    runs["equal_to_uninterrupted"] = file_bytes(out) == full
    rec = {"phase": f"19{part}", "card": label, **runs}
    print(json.dumps(rec), flush=True)
    if not rec["equal_to_uninterrupted"]:
        raise RuntimeError(f"19 ({part}): the resumed file differs from "
                           f"the uninterrupted one")
    r = runs["resume"]
    if r["deblock264_launches"] != r["p_frames"] + r["redos"] \
            or r["deblock264_launches"] == 0:
        raise RuntimeError(f"19 ({part}): deblock264 was not launched once "
                           f"for each P frame coded after the boundary")
    return rec


def phase_resumes(tmp, label):
    """19: resumes on the card, one JSON line a part with the card's name
    and power limit.  (a) R19_N 1080p y4m frames through hqdn3d and CFR
    at half rate (keyint R19_KEYINT), cut after GOP R19_CUT: hqdn3d keeps
    state, so the resume decodes and filters every frame from the start
    and drops those done after the filters; (b) job 7's clip with an IDR
    each R19_SRC_GOP frames as an mp4, scaled to R19_SCALE (frame-local),
    cut after GOP 2: the decode starts at the IDR before the boundary;
    (c) 12 (a)'s DVD at R19_DVD_N pictures with its AC-3 copied, its LPCM
    to AAC and the card burned, scaled to 1280x720 (frame-local), cut
    after GOP R19_DVD_CUT: the decode starts at the second GOP's I
    picture and its leading B pictures are dropped.  Each resumed file
    must equal the uninterrupted one."""
    import torch

    from handbrake_tpu_torch.codecs.h264.encoder import (EncoderConfig,
                                                         H264Encoder)
    from handbrake_tpu_torch.job import schema as S
    from handbrake_tpu_torch.mux.mp4 import MP4Writer
    from handbrake_tpu_torch.tools import profile_job as pj
    from handbrake_tpu_torch.utils.synth import make_clip, write_y4m
    t0 = time.perf_counter()
    scale = S.FilterSpec(S.FILTER_CROP_SCALE, {"width": R19_SCALE[0],
                                               "height": R19_SCALE[1]})
    # (a) hqdn3d and CFR at half rate
    src = os.path.join(tmp, "r19a.y4m")
    write_y4m(src, make_clip(W, H, R19_N, seed=23), W, H)

    def job_a(**kw):
        j = pj.unscaled_job(src, os.path.join(tmp, "r19a.mp4"))
        j.encoder_options = f"keyint={R19_KEYINT}"
        j.filters = [S.FilterSpec(S.FILTER_DENOISE, {}),
                     S.FilterSpec(S.FILTER_VFR, {"mode": 1,
                                                 "rate-num": 15000,
                                                 "rate-den": 1001})]
        for k, v in kw.items():
            setattr(j, k, v)
        return j
    a = resumed(label, "a", job_a, R19_CUT)
    ra = a["resume"]
    # the rate shaper goes ahead of hqdn3d: hqdn3d takes each frame it
    # gives, from the job's start, in both runs
    if ra["path"] != "start" or ra["frames_decoded"] != R19_N \
            or ra["hqdn3d_launches"] != a["full"]["hqdn3d_launches"] \
            or ra["hqdn3d_launches"] == 0:
        raise RuntimeError("19 (a): the resume did not decode and filter "
                           "every frame from the job's start")
    if ra["p_frames"] != sum(1 for i in range(a["done"], a["full"][
            "frames_coded"]) if i % R19_KEYINT):
        raise RuntimeError("19 (a): the resume coded other P frames than "
                           "those after the boundary")
    # (b) an H.264 mp4 with an IDR each R19_SRC_GOP frames, frame-local
    enc = H264Encoder(EncoderConfig(width=W, height=H, qp=QP,
                                    gop=R19_SRC_GOP, deblock=True,
                                    cabac=True, transform8x8=True))
    srcb = os.path.join(tmp, "r19b_src.mp4")
    w = MP4Writer(srcb)
    v = w.add_video_track(codec="h264", width=W, height=H)
    for i, f in enumerate(make_clip(W, H, R19_SRC_N, seed=9)):
        w.write_sample(v, enc.encode_frame(*f), duration=FRAME_TICKS,
                       sync=i % R19_SRC_GOP == 0, annexb=True)
    w.finalize()
    torch.cuda.synchronize()

    def job_b(**kw):
        j = pj.unscaled_job(srcb, os.path.join(tmp, "r19b.mp4"))
        j.encoder_options = f"keyint={R19_SRC_GOP}"
        j.filters = [scale]
        for k, v in kw.items():
            setattr(j, k, v)
        return j
    b = resumed(label, "b", job_b, 2)
    rb = b["resume"]
    if rb["path"] != "keyframe" or rb["video_packets_skipped"] != b["done"] \
            or rb["frames_decoded"] != R19_SRC_N - b["done"] \
            or rb["resample_launches"] != R19_SRC_N - b["done"]:
        raise RuntimeError("19 (b): the resume did not start the decode at "
                           "the IDR of the boundary")
    # (c) the DVD, frame-local, its leading B pictures dropped
    root, _ac3, n = dvd_folder(os.path.join(tmp, "r19_dvd"), R19_DVD_N)

    def job_c(**kw):
        j = S.Job(path=root, file=os.path.join(tmp, "r19c.mp4"), mux="mp4",
                  vcodec="h264", quality=28.0, encoder_profile="high",
                  encoder_options=f"keyint={R19_DVD_KEYINT}",
                  filters=[scale],
                  audio=[S.AudioJobTrack(track=0, encoder="copy:ac3"),
                         S.AudioJobTrack(track=1, encoder="aac",
                                         bitrate=160)],
                  subtitles=[S.SubtitleJobTrack(track=0, burn=True)], **kw)
        return j
    c = resumed(label, "c", job_c, R19_DVD_CUT)
    rc = c["resume"]
    if rc["path"] != "keyframe" or rc["frames_decoded"] >= n \
            or rc["video_packets_skipped"] == 0:
        raise RuntimeError("19 (c): the resume did not start the DVD's "
                           "decode at a keyframe")
    rec = {"a": a, "b": b, "c": c, "seconds": time.perf_counter() - t0}
    print(f"phase 19 ({label}): {rec['seconds']:.1f} s", flush=True)
    return rec


def phase_rates(tmp, label):
    """22: a stream's own frame rate and a copied track's true label on
    the card, one JSON line a part with the card's name and power limit.
    Its helper processes are stopped when it ends, whether it passes or
    fails."""
    try:
        return rates_parts(tmp, label)
    finally:
        for p in PROCS:
            if p.poll() is None:
                p.kill()
            p.wait()


def rates_sources(tmp):
    """22's sources: (a) R22_N 1080p frames coded on the card at
    24000/1001 as an annex-B .264 and at 25 fps in a TS (PES pts 3600
    ticks apart), each stream's VUI stating its rate; (b) that TS's video
    with a DTS-HD Master Audio track (stream type 0x86: 48 kHz 5.1 core
    frames, each followed by an extension substream whose lossless asset
    is 96 kHz, 8 channels) and an ADTS track (0x0F) whose
    channel_configuration is 0 and whose frames open with a 5.1 program
    config element; (c) the committed MJPEG AVI's first R22_MJPEG_N
    frames with the committed MP2 stream as its sound (WAVEFORMATEX tag
    0x50, a chunk a frame).  Returns ({name: path}, DTS frames, ADTS
    frames, MP2 frames)."""
    import torch
    from handbrake_tpu_torch.audio.frames import Framer
    from handbrake_tpu_torch.codecs.h264.encoder import (EncoderConfig,
                                                         H264Encoder)
    from handbrake_tpu_torch.sources.avi import AVIDemuxer
    from handbrake_tpu_torch.tools import source_builders as B
    from handbrake_tpu_torch.utils.synth import make_clip
    frames = make_clip(W, H, R22_N, seed=22)
    aus = {}
    for name, fps in (("24p", (24000, 1001)), ("25p", (25, 1))):
        enc = H264Encoder(EncoderConfig(width=W, height=H, qp=QP, gop=600,
                                        deblock=True, cabac=True,
                                        transform8x8=True, fps=fps))
        aus[name] = [enc.encode_frame(*f) for f in frames]
    torch.cuda.synchronize()
    paths = {k: os.path.join(tmp, f) for k, f in (
        ("annexb", "r22.264"), ("ts", "r22.ts"), ("sound", "r22_sound.ts"),
        ("avi", "r22.avi"))}
    with open(paths["annexb"], "wb") as f:
        f.write(b"".join(aus["24p"]))
    t0 = 90000
    video = [(t0 + 3600 * i, 0x100, 0xE0, au, t0 + 3600 * i)
             for i, au in enumerate(aus["25p"])]
    with open(paths["ts"], "wb") as f:
        f.write(B.build_ts([(0x1B, 0x100, b"")], video))
    dts = [B.dts_core_frame(size=1024, fill=k + 1) + B.dts_exss(
        900 + 8 * k, fill=k + 30, asset=(96000, 8, 1024), xll=True)
        for k in range(R22_SOUND_N)]
    adts = [B.adts_pce_frame(B.AAC_LAYOUTS["5.1"], 100 + k)
            for k in range(R22_SOUND_N)]
    sound = list(video)
    for pid, sid, fr, ticks in ((0x101, 0xFD, dts, 960),
                                (0x102, 0xC0, adts, 1920)):
        ends = np.cumsum([len(x) for x in fr]).tolist()
        sound += B.pes_units(pid, sid, fr, [t0 + ticks * k
                                            for k in range(len(fr))],
                             ends[2:-1:3])
    with open(paths["sound"], "wb") as f:
        f.write(B.build_ts([(0x1B, 0x100, b""), (0x86, 0x101, b""),
                            (0x0F, 0x102, b"")], sound))
    d = AVIDemuxer(os.path.join(B.FIXTURES, "mjpeg_640x480.avi"))
    try:
        mjpeg = [bytes(b.data) for _t, b in d.packets()][:R22_MJPEG_N]
    finally:
        d.close()
    fr = Framer("mp2", quiet=True)
    mp2 = [x.data for x in fr.feed(B.fixture("mp2_48k_stereo.mp2"))
           + fr.flush()][:R22_MJPEG_N * 40 // 24 + 1]
    with open(paths["avi"], "wb") as f:
        f.write(B.build_avi(mjpeg, (25, 1), (640, 480), [B.AviSound(
            0x50, 2, 48000, 16000, mp2, scale=1152)]))
    return paths, dts, adts, mp2


def rates_parts(tmp, label):
    from fractions import Fraction

    from handbrake_tpu_torch.audio import frames as F
    from handbrake_tpu_torch.audio.aacdec import AACDecoder
    from handbrake_tpu_torch.codecs.vui import stream_rate
    from handbrake_tpu_torch.scan import scan_title
    from handbrake_tpu_torch.tools import source_builders as B
    t0 = time.perf_counter()
    paths, dts, adts, mp2 = rates_sources(tmp)
    outs = {k: (os.path.join(tmp, f"r22_{k}.mp4"),
                os.path.join(tmp, f"r22_{k}_cpu.mp4"))
            for k in ("annexb", "ts", "avi")}
    cpu = {k: start_process(tmp, f"r22_{k}_cpu", [
        "-m", "handbrake_tpu_torch.cli", "-i", paths[k], "-o", outs[k][1],
        "--device", "cpu"], threads=R22_THREADS) for k in outs}
    rec = {"phase": "22", "card": label,
           "sources_s": time.perf_counter() - t0}
    # (a) the default preset on the 24000/1001 .264 and the 25 fps TS
    a = {}
    for k, rate, tick in (("annexb", Fraction(24000, 1001), None),
                          ("ts", Fraction(25), 3600)):
        title = scan_title(paths[k], preview_count=1)
        with log_lines() as lines:
            secs, dev_ms, db, _rs, spy = disc_job("cli", [
                "-i", paths[k], "-o", outs[k][0], "--previews", "1"])
        info, _samples = read_mp4(outs[k][0])
        durs = stts_durations(outs[k][0])[0]
        want = [int((i + 1) * 90000 / rate) - int(i * 90000 / rate)
                for i in range(R22_N)]
        a[k] = {"do_job_s": secs, "device_ms": dev_ms,
                "deblock264_launches": db, "p_frames": spy.p_frames(),
                "title_rate": [title.vrate_num, title.vrate_den],
                "vui_rate": str(stream_rate("h264", info.extradata)[0]),
                "stts": durs, "rate_log": next((
                    ln.split("hbtpu: ", 1)[-1] for ln in lines
                    if "fps from the SPS's VUI" in ln), None)}
        a[k]["ok"] = (Fraction(*a[k]["title_rate"]) == rate
                      and a[k]["vui_rate"] == str(rate)
                      and durs[:-1] == want[:-1] and len(durs) == R22_N
                      and a[k]["rate_log"] is not None
                      and a[k]["deblock264_launches"] >= a[k]["p_frames"]
                      > 0)
    # (b) the DTS-HD MA and ADTS 5.1 copies to mkv
    out_b = os.path.join(tmp, "r22_sound.mkv")
    secs, dev_ms, db, _rs, _spy = disc_job("cli", [
        "-i", paths["sound"], "-o", out_b, "-e", "h264", "-q", "28",
        "--encoder-profile", "high", "--previews", "1", "-a", "1,2", "-E",
        "copy:dts,copy:aac"])
    tracks, pk = read_tracks(out_b)
    pce = F.adts_pce(adts[0]).size
    b = {"do_job_s": secs, "device_ms": dev_ms, "deblock264_launches": db,
         "audio_tracks": [(t.codec, t.sample_rate, t.channels)
                          for t in tracks[1:]],
         "aac_config": bytes(tracks[2].extradata).hex()
         if len(tracks) > 2 else None,
         "dts_copy_equal": [p for _, p in pk.get(1, [])] == dts,
         "aac_copy_equal": [p for _, p in pk.get(2, [])]
         == [adts[0][7 + pce:]] + [x[7:] for x in adts[1:]],
         "dts_pts_ms": [t for t, _ in pk.get(1, [])][:4]}
    b["ok"] = (b["audio_tracks"] == [("dts", 96000, 8), ("aac", 48000, 6)]
               and b["aac_config"]
               == B.aac_pce_config(B.AAC_LAYOUTS["5.1"]).hex()
               and b["dts_copy_equal"] and b["aac_copy_equal"] and db > 0)
    # (c) the MJPEG AVI with its MP2 track to AAC, the default preset
    secs, dev_ms, db, _rs, spy = disc_job("cli", [
        "-i", paths["avi"], "-o", outs["avi"][0], "--previews", "1"])
    tracks, pk = read_tracks(outs["avi"][0])
    aac = np.concatenate([AACDecoder(tracks[1].extradata).decode_frame(p)
                          for _, p in pk[1]]) if len(tracks) > 1 else None
    c = {"do_job_s": secs, "device_ms": dev_ms, "deblock264_launches": db,
         "p_frames": spy.p_frames(),
         "tracks": [(t.kind, t.codec, t.sample_rate, t.channels)
                    for t in tracks],
         "aac_samples": int(aac.shape[0]) if aac is not None else 0,
         "aac_peak": float(np.abs(aac).max()) if aac is not None else 0.0}
    c["ok"] = (c["tracks"][1:] == [("audio", "aac", 48000, 2)]
               and abs(c["aac_samples"] - 1152 * len(mp2)) <= 2048
               and bool(np.isfinite(aac).all()) and c["aac_peak"] > 0.05
               and db >= c["p_frames"] > 0)
    for k in outs:
        finish_process(cpu[k])
        part = c if k == "avi" else a[k]
        part["equal_cpu_file"] = same_file(*outs[k])
        part["ok"] = part["ok"] and part["equal_cpu_file"]
    rec.update(a=a, b=b, c=c, seconds=time.perf_counter() - t0)
    for name, part in (("22a", a), ("22b", b), ("22c", c)):
        print(json.dumps(dict(part, part=name, card=label)), flush=True)
    print(f"phase 22 ({label}): {rec['seconds']:.1f} s", flush=True)
    bad = [k for k, part in (("a annexb", a["annexb"]), ("a ts", a["ts"]),
                             ("b", b), ("c", c)) if not part["ok"]]
    if bad:
        raise RuntimeError(f"22: the checks of {bad} failed")
    return rec


def rates_only() -> int:
    """Steps 1 and 22 alone (``--rates-only``)."""
    import handbrake_tpu_torch  # noqa: F401  (fails outside the repo)
    label = card()
    print(f"card: {label}", flush=True)
    phase_build()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        phase_rates(tmp, label)
    return 0


def phase_pfr(tmp, label):
    """23: HandBrake's peak-rate shaping on the card, one JSON line with
    the card's name and power limit.  Its helper process is stopped when
    it ends, whether it passes or fails."""
    try:
        return pfr_part(tmp, label)
    finally:
        for p in PROCS:
            if p.poll() is None:
                p.kill()
            p.wait()


def pfr_source(path):
    """23's source: R23_N 1280x720 frames coded on the card at 60 fps
    (the VUI states it) in an mp4 whose samples last 1500 ticks, with a
    48 kHz stereo AAC track (the port's AACEncoder) as long, each sound
    frame after the video frame it starts under."""
    import torch
    from handbrake_tpu_torch.audio.aac import AACEncoder
    from handbrake_tpu_torch.codecs.h264.encoder import (EncoderConfig,
                                                         H264Encoder)
    from handbrake_tpu_torch.mux.mp4 import MP4Writer
    from handbrake_tpu_torch.utils.synth import make_clip
    w, h = R23_SIZE
    enc = H264Encoder(EncoderConfig(width=w, height=h, qp=QP, gop=600,
                                    deblock=True, cabac=True,
                                    transform8x8=True, fps=(60, 1)))
    video = [enc.encode_frame(*f) for f in make_clip(w, h, R23_N, seed=23)]
    torch.cuda.synchronize()
    pcm = tone(48000, 2, R23_N * R23_SRC_TICKS * 48000 // 90000, 23)
    aac = AACEncoder(48000, 2)
    sound = aac.encode(pcm) + aac.flush()
    mp4 = MP4Writer(path)
    vi = mp4.add_video_track(codec="h264", width=w, height=h)
    ai = mp4.add_audio_track(codec="aac", sample_rate=48000, channels=2,
                             extradata=aac.audio_specific_config())
    k = 0
    for i, au in enumerate(video):
        mp4.write_sample(vi, au, duration=R23_SRC_TICKS, sync=i == 0,
                         annexb=True)
        while k < len(sound) and (k * 1024 * 90000 < (i + 1)
                                  * R23_SRC_TICKS * 48000 or i == R23_N - 1):
            mp4.write_sample(ai, sound[k], duration=1024)
            k += 1
    mp4.finalize()


def pfr_part(tmp, label):
    from handbrake_tpu_torch.codecs.vui import stream_rate
    t0 = time.perf_counter()
    src = os.path.join(tmp, "r23_60p.mp4")
    pfr_source(src)
    out, out_cpu = (os.path.join(tmp, f"r23{k}.mp4") for k in ("", "_cpu"))
    cpu = start_process(tmp, "r23_cpu", [
        "-m", "handbrake_tpu_torch.cli", "-i", src, "-o", out_cpu,
        "--previews", "1", "--device", "cpu"], threads=R23_THREADS)
    rec = {"phase": "23", "part": "23", "card": label,
           "source_s": time.perf_counter() - t0}
    with log_lines() as lines:
        secs, dev_ms, db, rs, spy = disc_job("cli", [
            "-i", src, "-o", out, "--previews", "1"])
    info, _samples = read_mp4(out)
    video, sound = stts_durations(out)[:2]
    peak_ticks = 90000 // R23_PEAK
    rec.update(do_job_s=secs, device_ms=dev_ms, deblock264_launches=db,
               resample_launches=rs, p_frames=spy.p_frames(),
               encoder_fps=list(spy.enc.cfg.fps),
               vui_rate=str(stream_rate("h264", info.extradata)[0]),
               stts=video, video_ticks=sum(video),
               sound_ticks=sum(sound) * 90000 // 48000 - R23_AAC_LATENCY,
               source_ticks=R23_N * R23_SRC_TICKS,
               pfr_log=next((ln.split("hbtpu: ", 1)[-1] for ln in lines
                             if ln.split("hbtpu: ", 1)[-1].startswith(
                                 "pfr: ")), None))
    want_log = (f"pfr: {R23_N // 2} frames dropped to hold the peak of "
                f"{R23_PEAK}/1 fps; the source runs at 60/1 fps, the "
                f"encoder and its rate control at {R23_PEAK}/1 fps")
    finish_process(cpu)
    rec["equal_cpu_file"] = same_file(out, out_cpu)
    rec["ok"] = (video == [peak_ticks] * (R23_N // 2)
                 and rec["video_ticks"] == rec["source_ticks"]
                 and abs(rec["video_ticks"] - rec["sound_ticks"])
                 <= peak_ticks
                 and rec["vui_rate"] == str(R23_PEAK)
                 and rec["encoder_fps"] == [R23_PEAK, 1]
                 and rec["pfr_log"] == want_log
                 and db >= rec["p_frames"] == R23_N // 2 - 1
                 and rec["equal_cpu_file"])
    rec["seconds"] = time.perf_counter() - t0
    print(json.dumps(rec), flush=True)
    print(f"phase 23 ({label}): {rec['seconds']:.1f} s", flush=True)
    if not rec["ok"]:
        raise RuntimeError("23: the peak-rate job's checks failed")
    return rec


def pfr_only() -> int:
    """Steps 1 and 23 alone (``--pfr-only``)."""
    import handbrake_tpu_torch  # noqa: F401  (fails outside the repo)
    label = card()
    print(f"card: {label}", flush=True)
    phase_build()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        phase_pfr(tmp, label)
    return 0


def resumes_only() -> int:
    """Steps 1 and 19 alone (``--resumes-only``)."""
    import handbrake_tpu_torch  # noqa: F401  (fails outside the repo)
    label = card()
    print(f"card: {label}", flush=True)
    phase_build()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        phase_resumes(tmp, label)
    return 0


def audio_copy_only() -> int:
    """Steps 1 and 18 alone (``--audio-copy-only``)."""
    import handbrake_tpu_torch  # noqa: F401  (fails outside the repo)
    label = card()
    print(f"card: {label}", flush=True)
    phase_build()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        phase_audio_copy(tmp, label)
    return 0


def discs_only() -> int:
    """Steps 1 and 12 alone (``--discs-only``), on step 7's stream
    encoded anew on the card (the same frames, settings and bytes)."""
    import handbrake_tpu_torch  # noqa: F401  (fails outside the repo)
    from handbrake_tpu_torch.codecs.h264.encoder import (EncoderConfig,
                                                         H264Encoder)
    from handbrake_tpu_torch.utils.synth import make_clip
    label = card()
    print(f"card: {label}", flush=True)
    phase_build()
    enc = H264Encoder(EncoderConfig(width=W, height=H, qp=QP, gop=600,
                                    deblock=True, cabac=True,
                                    transform8x8=True))
    stream = [enc.encode_frame(*f) for f in make_clip(W, H, SRC_N, seed=9)]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        phase_discs(tmp, label, stream, None)
    return 0


def anamorphic_only() -> int:
    """Steps 1 and 17 alone (``--anamorphic-only``)."""
    import handbrake_tpu_torch  # noqa: F401  (fails outside the repo)
    label = card()
    print(f"card: {label}", flush=True)
    phase_build()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        phase_anamorphic(tmp, label)
    return 0


def one_card():
    """Make only the first visible card visible to this process (before
    CUDA starts), so the run uses, and reports, exactly one card."""
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = (
        "0" if vis is None else vis.split(",")[0].strip())


def mesh_only() -> int:
    """Steps 1, 11 (c) and 14 alone (``--mesh-only``)."""
    import handbrake_tpu_torch  # noqa: F401  (fails outside the repo)
    label = card()
    print(f"card: {label}; cards at start: {CARDS_AT_START}", flush=True)
    phase_build()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        gp = phase_gop_parallel(tmp, label)
        phase_mesh(tmp, label, gp)
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--decode-check"]:
        return decode_check(*sys.argv[2:5])   # step 13's helper processes
    if sys.argv[1:2] == ["--walker-job"]:
        return walker_job_process(*sys.argv[2:])
    if sys.argv[1:2] == ["--mesh-rank"]:
        return mesh_rank_process(*sys.argv[2:])   # step 14's ranks
    CARDS_AT_START[:] = cards_at_start()
    one_card()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--mesh-only"]:
        return mesh_only()
    if sys.argv[1:2] == ["--anamorphic-only"]:
        return anamorphic_only()
    if sys.argv[1:2] == ["--audio-copy-only"]:
        return audio_copy_only()
    if sys.argv[1:2] == ["--resumes-only"]:
        return resumes_only()
    if sys.argv[1:2] == ["--discs-only"]:
        return discs_only()
    if sys.argv[1:2] == ["--rates-only"]:
        return rates_only()
    if sys.argv[1:2] == ["--pfr-only"]:
        return pfr_only()
    import handbrake_tpu_torch  # noqa: F401  (fails outside the repo)
    from handbrake_tpu_torch.utils.device import resolve_device
    resolve_device(None)
    t0 = time.perf_counter()
    label = card()
    print(f"card: {label}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    clock_hz = max_clock_hz()
    print(f"card: max SM clock {clock_hz / 1e6:.0f} MHz", flush=True)
    phase_build()
    entry = phase_kernel(label, clock_hz)
    launches, enc = phase_main_path(label)
    ms, b = phase_main_path_input(label, enc, clock_hz)
    job_a, rs, job_c, ms_lb = phase_job_path(label, clock_hz)
    _, job_i, hq_entry = phase_filter_suite(label, clock_hz)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        job_s, stream = phase_h264_source(tmp, label)
        job_au = phase_audio(tmp, label, stream)
        subs = phase_subtitles(tmp, label, stream)
        bf = phase_bframes(tmp, label)
        scale_out = phase_scale_out(tmp, label, stream)
        discs = phase_discs(tmp, label, stream, ms)
        hv = phase_hevc_av1(tmp, label)
        mesh = phase_mesh(tmp, label, scale_out["gop_parallel"])
        catalog = phase_catalog(tmp, label)
        refusals = phase_refusals(tmp, label, bf)
        par = phase_anamorphic(tmp, label)
        acopy = phase_audio_copy(tmp, label)
        res = phase_resumes(tmp, label)
        rates = phase_rates(tmp, label)
        pfr = phase_pfr(tmp, label)
    entry.update(launches=launches, ms=ms, bound_ms=b["bound_ms"],
                 bound_us=b["bound_ms"] * 1e3, bound_by=b["bound_by"],
                 chain_floor_us=b["chain_floor_us"],
                 ms_letterbox_input=ms_lb,
                 job_launches={"letterbox_2160p_cli": job_a["launches"],
                               "unscaled_1080p_do_job": job_c["launches"],
                               "interlaced_1080i_cli": job_i["launches"],
                               "h264_source_1080p_cli": job_s["launches"],
                               "audio_default_preset_cli":
                                   job_au["launches_default"],
                               "audio_three_tracks_mkv_cli":
                                   job_au["launches_three_tracks"],
                               "subtitles_pgs_text_cli":
                                   subs["job"]["launches"],
                               "letterbox_srt_burn_cli":
                                   subs["letterbox"]["launches"],
                               "resume_1080p_do_job":
                                   scale_out["resume"]
                                   ["deblock264_launches_resume"],
                               "dvd_720x480_cli":
                                   discs["dvd"]["deblock264_launches"],
                               "bluray_1080p_cli":
                                   discs["bd"]["deblock264_launches"],
                               "broadcast_ts_do_job":
                                   discs["ts"]["deblock264_launches"],
                               "mjpeg_avi_do_job":
                                   discs["mjpeg"]["deblock264_launches"],
                               "pal_16x9_dvd_cli":
                                   par["a"]["deblock264_launches"],
                               "loose_1440x1080_mkv_cli":
                                   par["b"]["deblock264_launches"],
                               "dvd_audio_preset_mp4_cli":
                                   acopy["a"]["deblock264_launches"],
                               "dvd_audio_copies_mkv_cli":
                                   acopy["b"]["deblock264_launches"],
                               **{f"resume_19{k}_do_job":
                                  res[k]["resume"]["deblock264_launches"]
                                  for k in "abc"},
                               "annexb_24p_1080p_cli":
                                   rates["a"]["annexb"]
                                   ["deblock264_launches"],
                               "ts_25p_1080p_cli":
                                   rates["a"]["ts"]["deblock264_launches"],
                               "dts_ma_adts_copies_mkv_cli":
                                   rates["b"]["deblock264_launches"],
                               "avi_mjpeg_mp2_cli":
                                   rates["c"]["deblock264_launches"],
                               "pfr_60p_720p_cli":
                                   pfr["deblock264_launches"]})
    rs_entry = {
        "name": "resample", "route": "cuda",
        "source": "handbrake_tpu_torch/csrc/resample.cu",
        "replaces": "handbrake_tpu/filters/kernels.py:90",
        "launches": job_a["resample_launches"],
        "launches_per_frame": job_a["resample_launches"] / N_FRAMES,
        "equal": rs["max_abs_err"] == 0, "max_abs_err": rs["max_abs_err"],
        "cases": rs["cases"], "ms": rs["ms"], "cold_ms": rs["cold_ms"],
        "plain_ms": rs["plain_ms"], "bound_ms": rs["bound_ms"],
        "bound_us": rs["bound_ms"] * 1e3, "bound_by": rs["bound_by"],
        "library_ms": rs["library_ms"], "device_ms": rs["device_ms"],
        "vpass_ms": None, "ms_dvd": rs["ms_dvd"],
        "bound_dvd_ms": rs["bound_dvd_ms"], "regs": rs["regs"],
        "local_bytes": rs["local_bytes"], "smem_bytes": rs["smem_bytes"],
        "filter_ms": rs["filter_ms"],
        "job_launches": {"letterbox_2160p_cli": job_a["resample_launches"],
                         "letterbox_srt_burn_cli":
                             subs["letterbox"]["resample_launches"],
                         "letterbox_bframes_cli": bf["resample_launches"],
                         "letterbox_gop_parallel_cli":
                             scale_out["gop_parallel"]["resample_launches"],
                         "letterbox_gop_parallel_2_ranks_cli_rank0":
                             mesh["a"]["resample_launches"][0],
                         "dvd_720x480_cli":
                             discs["dvd"]["resample_launches"],
                         "bluray_1080p_cli":
                             discs["bd"]["resample_launches"],
                         "pal_16x9_dvd_cli":
                             par["a"]["resample_launches"],
                         "loose_1440x1080_mkv_cli":
                             par["b"]["resample_launches"],
                         "dvd_audio_preset_mp4_cli":
                             acopy["a"]["resample_launches"],
                         "dvd_audio_copies_mkv_cli":
                             acopy["b"]["resample_launches"],
                         **{f"resume_19{k}_do_job":
                            res[k]["resume"]["resample_launches"]
                            for k in "bc"}}}
    hq_entry["job_launches"] = {
        "interlaced_1080i_cli": job_i["hqdn3d_launches"],
        "resume_19a_do_job": res["a"]["resume"]["hqdn3d_launches"]}
    if "jobs" in catalog:        # 15 (c), where libavcodec is present
        entry["job_launches"]["mpeg4_avi_do_job"] = \
            catalog["jobs"]["mpeg4"]["deblock264_launches"]
        rs_entry["job_launches"]["webm_1080p30_cli"] = \
            catalog["jobs"]["webm"]["resample_launches"]
    print(f"job 7 numbers: {json.dumps(job_s)}", flush=True)
    print(f"audio numbers: {json.dumps(job_au)}", flush=True)
    print(f"subtitle numbers: {json.dumps(subs)}", flush=True)
    print(f"bframes numbers: {json.dumps(bf)}", flush=True)
    print(f"phase 11 seconds: {scale_out['seconds']:.1f}", flush=True)
    print(f"phase 12 seconds: {discs['seconds']:.1f}", flush=True)
    print(f"phase 13 seconds: {hv['seconds']:.1f}", flush=True)
    print(f"phase 14 seconds: {mesh['seconds']:.1f}", flush=True)
    print(f"phase 15 seconds: {catalog['seconds']:.1f}", flush=True)
    print(f"phase 16 seconds: {refusals['seconds']:.1f}", flush=True)
    print(f"phase 17 seconds: {par['seconds']:.1f}", flush=True)
    print(f"phase 18 seconds: {acopy['seconds']:.1f}", flush=True)
    print(f"phase 19 seconds: {res['seconds']:.1f}", flush=True)
    print(f"phase 22 seconds: {rates['seconds']:.1f}", flush=True)
    print(f"phase 23 seconds: {pfr['seconds']:.1f}", flush=True)
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s in all", flush=True)
    print(json.dumps({"kernels": [entry, hq_entry, rs_entry]}))
    print(label)
    count = torch.cuda.device_count()
    if count != 1:
        raise RuntimeError(f"{count} cards visible, expected 1")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
