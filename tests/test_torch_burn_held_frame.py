"""A burned VobSub card on the last frame of a job whose decomb holds a
frame back, on the CPU, in both packages.

The card's end reaches the burn-in as a clear marker, after the last
frame has left the sync but while decomb still holds it (until the
flush).  The reference drops the card when the marker comes, so its
last frame is coded without it; the port ends the card there and drops
it only once a frame at or past that end comes, so the held frame keeps
it.  The DVD is ``chip_smoke.py`` 12 (a)'s, cut to the 176x144 fixture:
12 pictures, the card white from display frame 6 to past the end."""
import numpy as np
import pytest

from handbrake_tpu import work as jwork
from handbrake_tpu.job import schema as JS
from handbrake_tpu_torch import work
from handbrake_tpu_torch.codecs.registry import create_video_decoder
from handbrake_tpu_torch.job import schema as S
from handbrake_tpu_torch.sources.mp4 import MP4Demuxer
from handbrake_tpu_torch.subtitles.vobsub import build_spu
from handbrake_tpu_torch.tools import source_builders as B

TICKS = 3003
T0 = 4 * TICKS
CARD, CARD_AT = (48, 40, 64, 32), 6       # x, y, w, h; display frame


def _dvd(root):
    """The fixture's 12 pictures over two VOBs and a white card on
    subpicture stream 0x20, shown from CARD_AT to past the last frame."""
    es = B.fixture("mpeg2_176x144.m2v")
    units = B.video_units(es, T0, TICKS)
    n = len(units)
    x, y, w, h = CARD
    spu = build_spu(np.ones((h, w), np.uint8), x=x, y=y,
                    stop_delay=(n * TICKS) // 1024)
    at = T0 + CARD_AT * TICKS
    units.append((at, 0xBD, spu, B.spu_sub, at))
    half = n * TICKS / 90000 / 2
    return B.write_dvd(root, B.build_ps(units), 2, [half, half]), n


def _card_luma(path):
    """The card's mean luma (4 pixels in from its edges) a frame."""
    d = MP4Demuxer(path)
    dec = create_video_decoder("h264", d.tracks[0].extradata)
    frames = []
    for i in range(d.n_samples(0)):
        frames += dec.feed(d.read_sample(0, i))
    frames += dec.flush()
    d.close()
    x, y, w, h = CARD
    return [float(np.asarray(f.planes[0])[y + 4:y + h - 4,
                                          x + 4:x + w - 4].mean())
            for f in frames]


@pytest.fixture(scope="module")
def lumas(tmp_path_factory):
    d = tmp_path_factory.mktemp("held")
    root, n = _dvd(str(d / "disc"))
    got = {}
    for pkg, Sm in (("torch", S), ("jax", JS)):
        out = str(d / f"{pkg}.mp4")
        job = Sm.Job(path=root, file=out, mux="mp4", vcodec="h264",
                     quality=28.0,
                     filters=[Sm.FilterSpec(Sm.FILTER_DECOMB, {"mode": 7})],
                     subtitles=[Sm.SubtitleJobTrack(track=0, burn=True)])
        if pkg == "torch":
            work.do_job(job, device="cpu")
        else:
            # the reference encodes on its device path, as the port does:
            # some of the JAX package's tests leave HB_TPU_DISABLE_DEVICE=1
            # set in their worker, which would switch it to its host path
            with pytest.MonkeyPatch.context() as mp:
                mp.delenv("HB_TPU_DISABLE_DEVICE", raising=False)
                jwork.do_job(job)
        got[pkg] = _card_luma(out)
        assert len(got[pkg]) == n
    return got


def test_card_on_the_held_last_frame(lumas):
    """The port's last frame shows the card as the frames before it do:
    within their range, give or take one level of coding noise (the
    frames with the card are 254.7-254.9 here); no frame before CARD_AT
    shows it."""
    m = lumas["torch"]
    shown = m[CARD_AT:-1]
    assert min(shown) > 200
    assert min(shown) - 1 <= m[-1] <= max(shown) + 1
    assert max(m[:CARD_AT]) < 200


def test_reference_drops_the_card_from_the_held_frame(lumas):
    """The reference's frames equal the port's up to the last, which it
    codes without the card: its luma there stays that of the picture."""
    m, t = lumas["jax"], lumas["torch"]
    assert m[:-1] == t[:-1]
    assert m[-1] < min(t[CARD_AT:-1]) - 60
