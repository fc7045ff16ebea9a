"""``parallel/mesh.py`` and ``parallel/gop.py`` over a world of gloo ranks
on the CPU, held against the JAX package on its 8-device CPU mesh
(``tests/conftest.py``).

One world of 4 ranks (``torch_mesh_world.spawn``: processes of their
own, a file rendezvous, a hard time limit) runs every call of
``CALLS`` on rank 0 while ranks 1-3 serve its work items; the tests hold
its results against the reference's: GOP-parallel streams for G = 2, 4
and 6 (G = 6 deals ranks 2 GOPs or 1, G = 2 leaves two ranks idle), the
two-pass allocator's budgets, qps and streams, ``tile_smooth`` and
``build_multichip_step`` on a (2, 2) mesh, and nlmeans in row tiles over
2, 3 and 4 ranks against the untiled filter (the reference's sharded
call, with its edge-row fault, beside it).  A rank that raises fails its
world within the limit, named, with no process left behind; so does a
``Handle`` job whose work item fails on rank 0."""
import functools
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handbrake_tpu.codecs.h264 import encoder_tpu
from handbrake_tpu.filters.nlmeans import nlmeans_plane as j_nlmeans
from handbrake_tpu.parallel import gop as jgop
from handbrake_tpu.parallel import mesh as jmesh
from handbrake_tpu_torch.filters.nlmeans import nlmeans_plane
from handbrake_tpu_torch.job import schema as S
from handbrake_tpu_torch.parallel import mesh
from handbrake_tpu_torch.parallel.launch import RankFailed
from handbrake_tpu_torch.utils.device import ranks_per_card
from handbrake_tpu_torch.utils.synth import make_clip, write_y4m
from torch_mesh_world import Call, MeshSpec, spawn

W, H = 96, 64
RANKS = 4
LIMIT_S = 120
GOP = "handbrake_tpu_torch.parallel.gop:"
MESH = "handbrake_tpu_torch.parallel.mesh:"
KBPS, FPS2 = 60.0, (30, 1)
NL_KW = dict(strength=6.0, origin_tune=0.9, maxval=255)
# (rows, cols, tiles, patch, range, content): tiles that divide the
# plane, a short last tile (41 rows: 11, 11, 11, 8), three uneven tiles,
# and tiles too small for the halo (untiled on rank 0)
NL_CASES = [(64, 48, 2, 7, 3, "smooth"), (64, 48, 4, 7, 3, "noise"),
            (64, 48, 4, 3, 1, "smooth"), (41, 40, 4, 7, 3, "smooth"),
            (37, 40, 3, 5, 2, "noise"), (30, 40, 4, 7, 3, "smooth")]


def _frames(n):
    return make_clip(W, H, n, seed=5)


def _plane(kind, h, w, seed):
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, (h, w), np.uint8)
    return ((np.add.outer(np.arange(h), np.arange(w)) * 3 % 256)
            + rng.integers(0, 4, (h, w))).astype(np.uint8)


def _nl_refs(h, w, kind):
    cur = _plane(kind, h, w, h * w)
    return np.stack([cur, np.roll(cur, 1, 1)])


def _step_inputs(seed=7):
    rng = np.random.default_rng(seed)
    shapes = [(4, H, W), (4, H // 2, W // 2), (4, H // 2, W // 2),
              (4, H, W), (4, H // 2, W // 2), (4, H // 2, W // 2)]
    clip = make_clip(W, H, 8, seed=seed)
    planes = [np.stack([f[k] for f in clip[:4]]) for k in range(3)] \
        + [np.stack([f[k] for f in clip[4:]]) for k in range(3)]
    assert [p.shape for p in planes] == shapes
    x = rng.integers(0, 256, (4, H, W)).astype(np.int32)
    return x, planes


CALLS = {f"gop{G}": Call(GOP + "encode_gop_parallel",
                         (_frames(13), W, H, 28, G), {"device": "cpu"})
         for G in (2, 4, 6)}
CALLS["gop4-qp-per-frame"] = Call(
    GOP + "encode_gop_parallel",
    (_frames(10), W, H, [[26, 27, 28], [30, 29], [22, 36, 40], [41]], 4),
    {"device": "cpu"})
CALLS["2pass"] = Call(GOP + "encode_gop_parallel_2pass",
                      (_frames(12), W, H, KBPS, 4),
                      {"fps": FPS2, "device": "cpu"})
CALLS["smooth"] = Call(MESH + "tile_smooth", (MeshSpec(4, 2),), {},
                       (torch.from_numpy(_step_inputs()[0]),))
CALLS["step"] = Call(MESH + "build_multichip_step", (MeshSpec(4, 2), W // 16,
                                                     H // 16), {},
                     (*map(torch.from_numpy, _step_inputs()[1]), 28, 27))
for _c in NL_CASES:
    _refs = torch.from_numpy(_nl_refs(_c[0], _c[1], _c[5]))
    CALLS[f"nl{_c}"] = Call(MESH + "tile_shard_nlmeans",
                            (MeshSpec(_c[2], _c[2]),),
                            dict(patch=_c[3], rng=_c[4], **NL_KW),
                            (_refs[0], _refs))


class _CachedVmapJax:
    """jax, with vmap cached by (function, in_axes), so the reference's
    GOP-parallel calls of one shape and G share one executable."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    @functools.lru_cache(None)
    def _vmap(f, in_axes):
        return jax.vmap(f, in_axes=in_axes)

    def vmap(self, f, in_axes=0):
        return self._vmap(f, in_axes)


@pytest.fixture(scope="module", autouse=True)
def _reference_setup():
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("HB_TPU_DISABLE_DEVICE", raising=False)
        for name in ("build_p_analyzer", "build_p_analyzer_batch",
                     "build_p_analyzer_fn"):
            mp.setattr(encoder_tpu, name,
                       functools.lru_cache(None)(getattr(encoder_tpu, name)))
        mp.setattr(jgop, "jax", _CachedVmapJax())
        yield


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Rank 0's result of every call, by name, from one world of 4."""
    got = spawn(RANKS, list(CALLS.values()),
                workdir=str(tmp_path_factory.mktemp("world")),
                limit_s=LIMIT_S, device="cpu")
    return dict(zip(CALLS, got))


@pytest.mark.parametrize("case", ["gop2", "gop4", "gop6",
                                  "gop4-qp-per-frame"])
def test_gop_parallel_equals_reference(world, case):
    frames, w, h, qp, G = CALLS[case].args
    streams, full, aus = world[case]
    jstreams, jfull, jaus = jgop.encode_gop_parallel(
        frames, w, h, qp, jmesh.make_mesh(G, tile=1))
    assert streams == jstreams and full == jfull and aus == jaus


def test_two_pass_equals_reference(world):
    frames, w, h, kbps, G = CALLS["2pass"].args
    streams, full, st = world["2pass"]
    jstreams, jfull, jst = jgop.encode_gop_parallel_2pass(
        frames, w, h, kbps, jmesh.make_mesh(G, tile=1), fps=FPS2)
    assert streams == jstreams and full == jfull
    for k in ("budgets", "pass1_bits", "qps", "actual_kbps", "frame_aus"):
        assert st[k] == jst[k], k


def test_tile_smooth_equals_reference(world):
    x, _ = _step_inputs()
    want = np.asarray(jmesh.tile_smooth(jmesh.make_mesh(4, tile=2))(
        jnp.asarray(x)))
    got = world["smooth"]
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_multichip_step_equals_reference(world):
    """Each frame's analysis from the (2, 2) mesh against the reference's
    step on its (2, 2) mesh: every output key, dtype and value."""
    _, planes = _step_inputs()
    step = jmesh.build_multichip_step(jmesh.make_mesh(4, tile=2), W // 16,
                                      H // 16)
    jo = step(*(jnp.asarray(p) for p in planes), 28, 27)
    got = world["step"]
    assert len(got) == 4
    for b, to in enumerate(got):
        assert set(to) == set(jo)
        for k in jo:
            if k in ("payload", "payload_nib"):
                pairs = [(a, np.asarray(c)[b]) for a, c in zip(to[k], jo[k])]
            else:
                pairs = [(to[k], np.asarray(jo[k])[b])]
            for a, c in pairs:
                assert a.numpy().dtype == c.dtype, k
                assert np.array_equal(a.numpy(), c), (k, b)


def _close(got, want):
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    return int(d.max()) <= 1 and float((d != 0).mean()) < 0.01


@pytest.mark.parametrize("case", NL_CASES, ids=str)
def test_tiled_nlmeans_equals_untiled(world, case):
    """The tiles over the ranks equal the untiled filter bit for bit, the
    picture's edge rows included; the 64-row planes also against the
    reference's untiled filter, within the float filters' 1 LSB on under
    1 % of samples (one XLA compile a plane shape and setting)."""
    h, w, n, patch, rng, kind = case
    refs = _nl_refs(h, w, kind)
    got = world[f"nl{case}"].numpy()
    t = torch.from_numpy(refs)
    want = nlmeans_plane(t[0], t, patch=patch, rng=rng, **NL_KW).numpy()
    assert np.array_equal(got, want)
    if h == 64:
        ref = np.asarray(j_nlmeans(jnp.asarray(refs[0]), jnp.asarray(refs),
                                   patch=patch, rng=rng, **NL_KW))
        assert _close(got, ref)


@pytest.mark.parametrize("case", [(64, 48, 4, 3, 1, "smooth")], ids=str)
def test_tiled_nlmeans_beside_reference_sharded(world, case):
    """The reference's own tiled call on smooth content: its replicated
    edge rows enter the patch distances, so its picture's top and bottom
    rows differ from its untiled filter, and the port's tiles do not."""
    h, w, n, patch, rng, kind = case
    refs = _nl_refs(h, w, kind)
    sharded = np.asarray(jmesh.tile_shard_nlmeans(
        jmesh.make_mesh(n, tile=n), patch=patch, rng=rng, **NL_KW)(
        jnp.asarray(refs[0]), jnp.asarray(refs)))
    untiled = np.asarray(j_nlmeans(jnp.asarray(refs[0]), jnp.asarray(refs),
                                   patch=patch, rng=rng, **NL_KW))
    got = world[f"nl{case}"].numpy()
    reach = rng + patch // 2
    inner = slice(reach, h - reach)
    assert _close(got[inner], sharded[inner])
    edge = np.nonzero((sharded != untiled).any(1))[0]
    assert len(edge) and all(r < reach or r >= h - reach for r in edge)
    assert _close(got, untiled)


@pytest.mark.parametrize("h,n,halo", [(64, 4, 10), (41, 4, 10), (30, 4, 10),
                                      (37, 3, 7), (10, 1, 10)])
def test_tile_rows(h, n, halo):
    """ceil(h / n) rows a tile, the rest in the last; tiles too small
    for the halo (or one tile) mean untiled."""
    rows = mesh.tile_rows(h, n)
    assert sum(rows) == h and len(rows) == n
    assert all(r == -(-h // n) for r in rows[:-1])
    assert mesh.tiles_fit(h, n, halo) == (n > 1 and rows[0] >= halo)


def test_one_rank_mesh_without_process_group():
    """No process group: make_mesh is one rank on the caller's device,
    whatever it is asked for, and work items run in place."""
    m = mesh.make_mesh(4, tile=2, device="cpu")
    assert m.world is None and m.n == 1 and m.shape == {"gop": 1, "tile": 1}
    assert m.device == torch.device("cpu")
    assert m.run(lambda mm, root, a: (mm is m, root, a), 3, root=2) == (
        True, 2, 3)


def _fake_world(monkeypatch, sent):
    """Rank 0 of a world of 2 with no process group: the work items it
    would send are recorded in `sent`."""
    w = mesh.World(0, 2, torch.device("cpu"), "gloo")
    monkeypatch.setattr(w, "send_obj",
                        lambda dst, obj, group=None: sent.append(obj))
    return w


def _item(m, root, tag, log):
    log.append(("in", tag))
    time.sleep(0.02)
    log.append(("out", tag))
    if tag == "fail":
        raise ValueError("the item failed")
    return tag


def test_work_items_never_interleave(monkeypatch):
    """Jobs on threads (as hb.Handle runs them) hand out whole work
    items one at a time; an item that fails on rank 0 sends the serving
    rank an abort notice and leaves the world refusing the next, with no
    fallback to one rank."""
    sent, log = [], []
    m = mesh.Mesh(_fake_world(monkeypatch, sent), 2, 1)
    with ThreadPoolExecutor(4) as pool:
        got = list(pool.map(lambda k: m.run(_item, k, log), range(8)))
    assert got == list(range(8))
    assert all(a == ("in", b[1]) and b[0] == "out"
               for a, b in zip(log[::2], log[1::2]))
    assert [(op, fn) for op, _n, _t, _mod, fn, _a in sent] == [
        ("run", "_item")] * 8
    with pytest.raises(ValueError):
        m.run(_item, "fail", log)
    assert sent[-1] == ("abort", "_item", "ValueError('the item failed')")
    with pytest.raises(RuntimeError, match="broke off in _item"):
        m.run(_item, 9, log)


def test_closed_world_refuses_a_mesh(monkeypatch):
    w = _fake_world(monkeypatch, [])
    w.closed = True
    monkeypatch.setattr(mesh, "_world", [w])
    with pytest.raises(RuntimeError, match="closed"):
        mesh.make_mesh(tile=1)


@pytest.mark.parametrize("lws,cards,per_card,rank1", [
    (1, 1, 1, 1), (2, 1, 2, 0), (4, 4, 1, 1), (4, 2, 2, 0), (3, 2, 2, 0)])
def test_ranks_share_cards(monkeypatch, lws, cards, per_card, rank1):
    """LOCAL_WORLD_SIZE ranks over the cards: a card each where there
    are enough (NCCL), else in order, several a card (gloo); local rank
    1's card."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(lws))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert ranks_per_card() == per_card
    assert 1 // ranks_per_card() == rank1


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split()[2] != "Z"
    except OSError:
        return False


def test_failing_rank_fails_the_job(tmp_path):
    """GOP 1 lives on rank 1 and its qps break off at its third frame:
    rank 1 raises mid-window, the world fails within its limit with rank
    1 and its error named, and no rank's process is left."""
    frames = _frames(8)
    bad = [[28] * 4, [28, 28, "x", 28]]
    with pytest.raises(RankFailed) as e:
        spawn(2, [Call(GOP + "encode_gop_parallel", (frames, W, H, bad, 2),
                       {"device": "cpu"})],
              workdir=str(tmp_path), limit_s=60, device="cpu")
    msg = str(e.value)
    assert "rank 1 (exit 1)" in msg and "mesh rank 1 of 2 failed" in msg
    assert "invalid literal for int()" in msg
    _none_left(e.value.pids)


def test_handle_job_failing_on_rank_zero_ends_the_world(tmp_path):
    """A Handle job whose work item fails on rank 0 while rank 1 waits
    mid-item for its next frames: rank 0 aborts the world and rank 1
    ends at once, named, long before the process group's 600 s timeout
    (the world's limit is 60 s); no process is left."""
    y4m = write_y4m(str(tmp_path / "in.y4m"), _frames(12), W, H, 0, (30, 1))
    job = S.Job(path=y4m, file=str(tmp_path / "out.mp4"), mux="mp4",
                vcodec="h264", quality=28.0, gop_parallel=4)
    t0 = time.monotonic()
    with pytest.raises(RankFailed) as e:
        spawn(2, [Call("torch_mesh_world:handle_job_failing_on_rank_zero",
                       (job, "cpu"))],
              workdir=str(tmp_path / "w"), limit_s=60, device="cpu",
              timeout_s=600)
    assert time.monotonic() - t0 < 45
    msg = str(e.value)
    assert "still running" not in msg
    assert "rank 1 (exit 1)" in msg
    assert ("mesh rank 1 of 2: rank 0 aborted the world: its work item "
            "_encode_item failed: RuntimeError('the entropy coder failed on "
            "rank 0')") in msg
    _none_left(e.value.pids)


def _none_left(pids):
    """None of the world's ranks is still a live process."""
    assert len(pids) == 2
    assert not [p for p in pids if _alive(p) and "spawn_main" in _cmdline(p)]


def _cmdline(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().replace(b"\0", b" ").decode(errors="replace")
    except OSError:
        return ""


def test_world_past_its_limit_is_killed(tmp_path):
    """A world still running at its limit is killed, ranks named."""
    frames = _frames(40)
    with pytest.raises(RankFailed, match=r"still running after 0.5 s"):
        spawn(2, [Call(GOP + "encode_gop_parallel", (frames, W, H, 28, 2),
                       {"device": "cpu"})],
              workdir=str(tmp_path), limit_s=0.5, device="cpu")
