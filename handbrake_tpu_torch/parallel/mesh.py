"""Several cards in one job — the counterpart of
``handbrake_tpu/parallel/mesh.py`` on ``torch.distributed``.

The reference lays its devices out as a (gop, tile) mesh in one process
and lets XLA place the collectives.  The port runs one process a card
(``torchrun --nproc-per-node N``): a ``World`` is this process's place in
the process group, and a ``Mesh`` is a (gop, tile) view of its first n
ranks, shaped as the reference shapes its devices.

Rank 0 runs the job (source, sync, filter graph, rate control, mux,
journal).  The other ranks run ``World.serve``: rank 0 hands each work
item to the ranks of its mesh as a function of this package and its
arguments (``Mesh.run``), every rank of the mesh runs that function with
its own part of the data, and the results come back to rank 0.  One work
item runs at a time (a lock, so jobs on several threads never interleave
their items), until ``World.close`` releases the other ranks.  The data
moves by send/recv between the ranks that need it: the reference's
one-hop ``ppermute`` of halo rows becomes send/recv between tile
neighbours, its resharding collective a gather within each tile group,
its ``psum`` an ``all_gather``.

The backend is NCCL when every rank has a card of its own and gloo on
the CPU or when several ranks share a card; the world states which and
why.  Gloo moves no CUDA tensors, so under gloo the world stages them
through the host, and under NCCL host arrays go up to the card first.
Control messages (the work items and small results) go over gloo in
either case.  A rank that fails raises out of its work item and its
process exits, which fails the job: nothing carries on serially.  A work
item that fails on rank 0 aborts the world: rank 0 sends each serving
rank word on a gloo group kept for it, where a thread of the serving
rank waits, and the serving rank ends its process at once, named, rather
than waiting mid-item for the group's timeout.
Without a process group ``make_mesh`` returns a one-rank mesh on the
caller's device, and every function here runs there untouched.
"""
from __future__ import annotations

import atexit
import importlib
import os
import pickle
import sys
import threading
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import ranks_per_card, resolve_device
from ..utils.logging import log

TIMEOUT_S = 600.0      # a process group's timeout for one operation
IDLE_S = 7 * 86400.0   # how long a serving rank waits for its next item

_world = [None]
_world_lock = threading.Lock()


class World:
    """This process's place in the process group: its rank, the group's
    size, its device and the backend, and the wire between ranks.
    Counters (work items, bytes each way, seconds blocked on the wire)
    are the scale-out layer's metrics."""

    def __init__(self, rank: int, size: int, device: torch.device,
                 backend: str, ctrl=None, watch=None):
        self.rank, self.size = rank, size
        self.device, self.backend = device, backend
        self.ctrl = ctrl            # gloo group of the control messages
        self.watch = watch          # gloo group of rank 0's abort notices
        self.lock = threading.RLock()
        self.closed = False
        self.failed = None          # the work item that broke off
        self.stats = {"items": 0, "bytes_sent": 0, "bytes_received": 0,
                      "wait_s": 0.0}

    # -- control messages: pickled objects over gloo ----------------------
    # (group: the watch group, whose notices the stats do not count, so
    # that the watcher thread writes none of them)
    def send_obj(self, dst: int, obj, group=None):
        data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        dist.send(torch.tensor([len(data)], dtype=torch.int64), dst,
                  group=group or self.ctrl)
        dist.send(torch.frombuffer(bytearray(data), dtype=torch.uint8), dst,
                  group=group or self.ctrl)
        if group is None:
            self.stats["bytes_sent"] += len(data) + 8

    def recv_obj(self, src: int, timeout_s: float | None = None,
                 group=None):
        counted, group = group is None, group or self.ctrl
        t0 = time.perf_counter()
        n = torch.empty(1, dtype=torch.int64)
        w = dist.irecv(n, src, group=group)
        if timeout_s is None:
            w.wait()
        else:
            w.wait(timedelta(seconds=timeout_s))
        buf = torch.empty(int(n), dtype=torch.uint8)
        dist.recv(buf, src, group=group)
        if counted and timeout_s is None:
            self.stats["wait_s"] += time.perf_counter() - t0
        if counted:
            self.stats["bytes_received"] += int(n) + 8
        return pickle.loads(buf.numpy().tobytes())

    # -- tensors: raw bytes over the backend ------------------------------
    def _wire(self, t) -> torch.Tensor:
        """t (a tensor or a numpy array) as flat bytes where the backend
        takes them: the host for gloo, the card for NCCL."""
        if isinstance(t, np.ndarray):
            t = torch.from_numpy(np.require(t, requirements=["C", "W"]))
        t = t.contiguous()
        if self.backend == "gloo" and t.is_cuda:
            t = t.cpu()
        elif self.backend == "nccl" and not t.is_cuda:
            t = t.to(self.device)
        return t.reshape(-1).view(torch.uint8)

    def post(self, sends=(), recvs=()) -> "Pending":
        """Start sends [(dst, tensor or array)] and receives [(src,
        shape, dtype)] together; ``wait()`` on the result returns the
        received tensors on this rank's device, in order."""
        ops, keep, bufs = [], [], []
        for dst, t in sends:
            b = self._wire(t)
            if b.numel():
                ops.append(dist.P2POp(dist.isend, b, dst))
                keep.append(b)
                self.stats["bytes_sent"] += b.numel()
        for src, shape, dtype in recvs:
            nbytes = int(np.prod(shape)) * torch.empty(
                (), dtype=dtype).element_size()
            b = torch.empty(nbytes, dtype=torch.uint8,
                            device=self.device if self.backend == "nccl"
                            else "cpu")
            if nbytes:
                ops.append(dist.P2POp(dist.irecv, b, src))
                self.stats["bytes_received"] += nbytes
            bufs.append((b, shape, dtype))
        works = dist.batch_isend_irecv(ops) if ops else []
        return Pending(self, works, keep, bufs)

    def exchange(self, sends=(), recvs=()) -> list:
        return self.post(sends, recvs).wait()

    def all_gather(self, a: np.ndarray) -> np.ndarray:
        """(size, *a.shape): every rank's array, in rank order."""
        t = self._wire(a).view(torch.from_numpy(a).dtype)
        out = [torch.empty_like(t) for _ in range(self.size)]
        t0 = time.perf_counter()
        dist.all_gather(out, t)
        self.stats["wait_s"] += time.perf_counter() - t0
        return np.stack([o.cpu().numpy().reshape(a.shape) for o in out])

    # -- the work loop ----------------------------------------------------
    def serve(self):
        """Run the work items rank 0 hands out until it closes the
        world (ranks other than 0).  An item that raises ends the loop
        with the error, named with this rank."""
        if self.rank == 0:
            raise RuntimeError("rank 0 hands out work items; it does not "
                               "serve them")
        watcher = threading.Thread(target=self._watch, daemon=True,
                                   name=f"mesh-watch:{self.rank}")
        watcher.start()
        with self.lock:
            while not self.closed:
                msg = self.recv_obj(0, timeout_s=IDLE_S)
                if msg[0] == "close":
                    self.closed = True
                    break
                _op, n, tile, mod, name, args = msg
                fn = _resolve(mod, name)
                try:
                    fn(Mesh(self, n, tile), None, *args)
                except Exception as e:
                    raise RuntimeError(f"mesh rank {self.rank} of "
                                       f"{self.size} failed in {name}: "
                                       f"{e!r}") from e
                self.stats["items"] += 1
        watcher.join()
        log(f"mesh: rank {self.rank} served {self.stats}")
        _destroy()

    def _watch(self):
        """A serving rank's thread: rank 0's last word on the watch group.
        "close" ends the watch; "abort" (a work item failed on rank 0,
        which leaves this rank waiting mid-item on data that will not
        come) ends this process at once with exit code 1, named.  A group
        that breaks (rank 0 gone) ends the watch: the serving loop meets
        the same fault and raises."""
        try:
            msg = self.recv_obj(0, timeout_s=IDLE_S, group=self.watch)
        except Exception:  # noqa: BLE001 — the loop reports it
            return
        if msg[0] == "abort":
            print(f"mesh rank {self.rank} of {self.size}: rank 0 aborted "
                  f"the world: its work item {msg[1]} failed: {msg[2]}",
                  file=sys.stderr, flush=True)
            sys.stdout.flush()
            os._exit(1)

    def abort(self, name: str, err: BaseException):
        """Rank 0, after work item `name` failed here: tell every serving
        rank to end its process (a rank already gone is passed over).
        The world refuses every later item."""
        self.failed = name
        log(f"mesh: rank 0 failed in {name}: {err!r}; aborting the world")
        for r in range(1, self.size):
            try:
                self.send_obj(r, ("abort", name, repr(err)),
                              group=self.watch)
            except Exception as e:  # noqa: BLE001 — that rank is gone
                log(f"mesh: rank {r} took no abort notice: {e!r}")

    def close(self):
        """Rank 0: release the serving ranks and leave the process group.
        After an abort (``abort``) the serving ranks have ended, and the
        group is left as it is."""
        with _world_lock:
            if self.closed:
                return
            self.closed = True
        if self.rank == 0 and self.failed is None:
            with self.lock:
                for r in range(1, self.size):
                    # the watch first: the serving rank joins its watcher
                    # before it leaves the group
                    self.send_obj(r, ("close",), group=self.watch)
                    self.send_obj(r, ("close",))
            log(f"mesh: rank 0 closed the world: {self.stats}")
            _destroy()


class Pending:
    """Sends and receives in flight (``World.post``)."""

    def __init__(self, world, works, keep, bufs):
        self.world, self.works, self.keep, self.bufs = (world, works, keep,
                                                        bufs)

    def wait(self) -> list:
        t0 = time.perf_counter()
        for w in self.works:
            w.wait()
        self.world.stats["wait_s"] += time.perf_counter() - t0
        self.keep = []
        return [b.view(dtype).reshape(shape).to(self.world.device)
                for b, shape, dtype in self.bufs]


def _resolve(mod: str, name: str):
    """A work item's function: a module-level function of this package."""
    root = __name__.split(".")[0]
    if mod.split(".")[0] != root or "." in name:
        raise RuntimeError(f"refusing work item {mod}:{name}: not a "
                           f"module-level function of {root}")
    return getattr(importlib.import_module(mod), name)


def _destroy():
    if dist.is_initialized():
        dist.destroy_process_group()


def current_world() -> World | None:
    return _world[0]


def init_world(device=None, init_method: str | None = None,
               rank: int | None = None, world_size: int | None = None,
               timeout_s: float = TIMEOUT_S) -> World | None:
    """This process's world, joined on first use: the ranks torchrun's
    environment gives (RANK, WORLD_SIZE, env:// rendezvous) unless rank,
    world_size and init_method are given.  One rank (no WORLD_SIZE above
    1) makes no world and returns None.  The entry points (the CLI,
    do_job) call it, so torchrun's ranks join without a word."""
    with _world_lock:
        if _world[0] is not None:
            return _world[0]
        if world_size is None:
            world_size = int(os.environ.get("WORLD_SIZE", 1))
            rank = int(os.environ.get("RANK", 0))
        if world_size <= 1:
            return None
        dev = resolve_device(device)
        if dev.type == "cpu":
            backend, why = "gloo", "the ranks run on the CPU"
        elif ranks_per_card() > 1:
            backend, why = "gloo", (f"{ranks_per_card()} ranks share each "
                                    f"card and NCCL takes one rank a card")
        else:
            backend, why = "nccl", "every rank has a card of its own"
        timeout = timedelta(seconds=timeout_s)
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world_size,
                                timeout=timeout)
        ctrl = None
        if backend == "nccl":
            ctrl = dist.new_group(backend="gloo", timeout=timeout)
            # the first NCCL call involves every rank (batched sends and
            # receives then share its communicator)
            dist.barrier(device_ids=[dev.index])
        watch = dist.new_group(backend="gloo", timeout=timeout)
        w = World(rank, world_size, dev, backend, ctrl, watch)
        log(f"mesh: rank {rank} of {world_size} on {dev}, backend "
            f"{backend}: {why}")
        if rank == 0:
            atexit.register(w.close)
        _world[0] = w
        return w


class Mesh:
    """(gop, tile) view of the first n ranks of the world, rank m at
    (m // tile, m % tile) as the reference reshapes its device list; or
    one rank on the caller's device when there is no world."""

    def __init__(self, world: World | None, n: int = 1, tile: int = 1,
                 device=None):
        if n % tile:
            raise ValueError(f"{n} ranks do not form rows of {tile} tiles")
        self.world, self.n, self.tile = world, n, tile
        self.shape = {"gop": n // tile, "tile": tile}
        self.rank = world.rank if world is not None else 0
        self.device = world.device if world is not None \
            else resolve_device(device)

    def coords(self, m: int | None = None) -> tuple:
        return divmod(self.rank if m is None else m, self.tile)

    def rank_of(self, i: int, j: int) -> int:
        return i * self.tile + j

    def run(self, fn, *args, root=None):
        """Run work item fn(mesh, root, *args) on every rank of the mesh
        (root: rank 0's data, None elsewhere); rank 0's return value.
        fn is a module-level function of this package and args are
        small: the data moves inside fn."""
        w = self.world
        if w is None or self.n == 1:
            return fn(self, root, *args)
        if w.rank != 0:
            raise RuntimeError("only rank 0 hands out work items")
        with w.lock:
            if w.closed or w.failed is not None:
                raise RuntimeError(f"the mesh is closed or broke off in "
                                   f"{w.failed}")
            w.failed = fn.__name__          # until the item completes
            item = ("run", self.n, self.tile, fn.__module__, fn.__name__,
                    args)
            try:
                for r in range(1, self.n):
                    w.send_obj(r, item)
                out = fn(self, root, *args)
            except BaseException as e:
                w.abort(fn.__name__, e)
                raise
            w.failed = None
            w.stats["items"] += 1
            return out


def make_mesh(n_devices: int | None = None, *, tile: int,
              device=None) -> Mesh:
    """Mesh over the first n ranks of the world, shaped (gop, tile):
    tile=1 for pure GOP parallelism, tile=n for row tiles.  Without a
    process group the mesh is one rank on `device` (None: the CUDA
    card).  A rank count above the world's is the world's, as the
    reference's device slice is.  A world on another kind of device than
    `device` (None: the card) raises, and so does a closed world: nothing
    falls back to one rank or to the CPU."""
    w = current_world()
    if w is None:
        return Mesh(None, device=device)
    if w.closed:
        raise RuntimeError("the mesh's world is closed")
    want = torch.device("cuda" if device is None else device)
    if want.type != w.device.type:
        raise ValueError(f"the world runs on {w.device}, not {want}")
    n = w.size if n_devices is None else max(1, min(n_devices, w.size))
    return Mesh(w, n, tile)


# ---------------------------------------------------------------------------
# halo exchange over the tile axis
# ---------------------------------------------------------------------------
def _halo_pad(mesh: Mesh, x: torch.Tensor, halo: int, rows: list) -> tuple:
    """x (..., h, W), this rank's row tile, with up to `halo` rows of each
    tile neighbour attached by send/recv (one hop: rows[k] is tile k's
    height).  The picture's outer edges get no rows: a filter run on the
    result meets the picture's own edge there, as the untiled filter
    does.  (The reference replicates the edge rows instead, which makes
    its tiles differ from its untiled filter.)  Returns (padded, rows
    attached above, rows attached below)."""
    i, j = mesh.coords()
    sends, recvs, shape = [], [], tuple(x.shape[:-2])
    above = min(halo, rows[j - 1]) if j > 0 else 0
    below = min(halo, rows[j + 1]) if j < mesh.tile - 1 else 0
    h = x.shape[-2]
    if j > 0:
        up = mesh.rank_of(i, j - 1)
        sends.append((up, x[..., :min(halo, h), :]))
        recvs.append((up, shape + (above, x.shape[-1]), x.dtype))
    if j < mesh.tile - 1:
        down = mesh.rank_of(i, j + 1)
        sends.append((down, x[..., h - min(halo, h):, :]))
        recvs.append((down, shape + (below, x.shape[-1]), x.dtype))
    got = mesh.world.exchange(sends, recvs) if sends else []
    top = [got.pop(0)] if j > 0 else []
    return torch.cat(top + [x] + got, dim=-2), above, below


def _halo_blur_local(mesh: Mesh, x: torch.Tensor, rows: list):
    """Vertical [1,2,1]/4 smooth of this rank's rows with a one-row
    halo from each tile neighbour; the picture's outer edges replicate
    (the untiled smooth's edge rule).  x: (B, h, W) int32."""
    xp, above, below = _halo_pad(mesh, x, 1, rows)
    xp = torch.cat([xp[:, :1]] * (1 - above) + [xp]
                   + [xp[:, -1:]] * (1 - below), dim=1)
    return (xp[:, :-2] + 2 * xp[:, 1:-1] + xp[:, 2:] + 2) >> 2


def _blocks(n: int, parts: int) -> list:
    """[(start, length)]: n rows or frames in `parts` equal blocks."""
    if n % parts:
        raise ValueError(f"{n} does not divide into {parts} blocks")
    k = n // parts
    return [(p * k, k) for p in range(parts)]


def _smooth_scatter(mesh: Mesh, x, B, H, W):
    """Block (i, j) of x (B, H, W) on each rank: frames of gop block i,
    rows of tile j; then the smooth with its halo exchange."""
    bb, rb = _blocks(B, mesh.shape["gop"]), _blocks(H, mesh.tile)
    if mesh.rank == 0:
        x = torch.as_tensor(x).to(mesh.device, torch.int32)
        sends = [(m, x[bb[i][0]:sum(bb[i]), rb[j][0]:sum(rb[j])])
                 for m in range(1, mesh.n)
                 for i, j in [mesh.coords(m)]]
        if sends:
            mesh.world.exchange(sends)
        mine = x[:bb[0][1], :rb[0][1]]
    else:
        i, j = mesh.coords()
        mine = mesh.world.exchange(recvs=[(0, (bb[i][1], rb[j][1], W),
                                           torch.int32)])[0]
    return _halo_blur_local(mesh, mine, [k for _s, k in rb]), bb, rb


def _tile_smooth_item(mesh: Mesh, x, B, H, W):
    out, bb, rb = _smooth_scatter(mesh, x, B, H, W)
    if mesh.rank != 0:
        mesh.world.exchange([(0, out)])
        return None
    recvs = [(m, (bb[i][1], rb[j][1], W), torch.int32)
             for m in range(1, mesh.n) for i, j in [mesh.coords(m)]]
    got = [out] + (mesh.world.exchange(recvs=recvs) if recvs else [])
    return torch.cat([torch.cat(got[i * mesh.tile:(i + 1) * mesh.tile],
                                dim=1) for i in range(mesh.shape["gop"])])


def tile_smooth(mesh: Mesh):
    """fn(x): x (B, H, W) int32 on rank 0 → the smoothed frames on rank
    0, computed in (gop, tile) blocks over the mesh (B divisible by the
    gop axis, H by the tile axis, as the reference's shard_map needs)."""
    def smooth(x):
        B, H, W = (int(s) for s in x.shape)
        return mesh.run(_tile_smooth_item, B, H, W, root=x)
    return smooth


def _multichip_item(mesh: Mesh, planes, B, H, W, mb_w, mb_h, qp, qpc):
    """Smooth in (gop, tile) blocks, gather each gop row's tiles on its
    first rank, analyse the row's frames there and return the analyses to
    rank 0 in frame order."""
    from ..codecs.h264.analyzer import build_p_analyzer_fn
    y = planes[0] if planes is not None else None
    if planes is not None:
        planes = [torch.as_tensor(p).to(torch.uint8) for p in planes[1:]]
    sm, bb, rb = _smooth_scatter(mesh, y, B, H, W)
    i, j = mesh.coords()
    w = mesh.world
    if j > 0:
        w.exchange([(mesh.rank_of(i, 0), sm)])
        return None
    rest = [(mesh.rank_of(i, jj), (bb[i][1], rb[jj][1], W), torch.int32)
            for jj in range(1, mesh.tile)]
    ys = torch.cat([sm] + (w.exchange(recvs=rest) if rest else []), dim=1)
    # the other planes of the row's frames, from rank 0
    s, k = bb[i]
    shapes = [(k, H // 2, W // 2), (k, H // 2, W // 2), (k, H, W),
              (k, H // 2, W // 2), (k, H // 2, W // 2)]
    if mesh.rank == 0:
        sends = []
        for m in range(mesh.tile, mesh.n, mesh.tile):
            s2, k2 = bb[mesh.coords(m)[0]]
            sends += [(m, p[s2:s2 + k2]) for p in planes]
        if sends:
            w.exchange(sends)
        rest = [p[s:s + k].to(mesh.device) for p in planes]
    else:
        rest = w.exchange(recvs=[(0, sh, torch.uint8) for sh in shapes])
    u, v, ry, ru, rv = rest
    fn = build_p_analyzer_fn(mb_w, mb_h)
    outs = [fn(ys[b], u[b], v[b], ry[b], ru[b], rv[b], qp, qpc)
            for b in range(k)]
    if mesh.rank != 0:
        w.send_obj(0, [_to(o, "cpu") for o in outs])
        return None
    for m in range(mesh.tile, mesh.n, mesh.tile):
        outs += [_to(o, mesh.device) for o in w.recv_obj(m)]
    return outs


def _to(o, dev):
    """An analysis (dicts and lists of tensors) with its tensors on dev."""
    if isinstance(o, torch.Tensor):
        return o.to(dev)
    if isinstance(o, dict):
        return {k: _to(v, dev) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return type(o)(_to(v, dev) for v in o)
    return o


def build_multichip_step(mesh: Mesh, mb_w: int, mb_h: int):
    """The reference's pipeline step over a (gop, tile) mesh: the
    tile-sharded smooth of the luma, then the P-frame analysis of each
    frame against its reference, each gop row's frames on that row's
    first rank (the reference's resharding collective is the gather
    within the row).

    Returns step(y, u, v, ry, ru, rv, qp, qpc) → a list of the frames'
    analyses on rank 0, where y/u/v/ry/ru/rv are batched on axis 0 (the
    batch a multiple of mesh.shape["gop"]) and the luma is smoothed as
    int32."""
    def step(y, u, v, ry, ru, rv, qp, qpc):
        B, H, W = (int(s) for s in y.shape)
        return mesh.run(_multichip_item, B, H, W, mb_w, mb_h, int(qp),
                        int(qpc), root=(y, u, v, ry, ru, rv))
    return step


# ---------------------------------------------------------------------------
# nlmeans in row tiles
# ---------------------------------------------------------------------------
def tile_rows(h: int, n: int) -> list:
    """Heights of n row tiles of an h-row plane: ceil(h / n) rows each,
    the last tile the rest (the reference pads h to a multiple of n)."""
    k = -(-h // n)
    return [min(k, max(0, h - t * k)) for t in range(n)]


def tiles_fit(h: int, n: int, halo: int) -> bool:
    """Whether n tiles of an h-row plane each hold `halo` rows, as the
    reference's ``_sharded`` asks (the last one may be shorter: the
    picture ends there)."""
    return n > 1 and -(-h // n) >= halo and tile_rows(h, n)[-1] > 0


def _nlmeans_item(mesh: Mesh, refs, T, H, W, dtype, cfg):
    """Each rank filters its row tile of refs[0] (searching refs) with
    rng + patch rows of each neighbour attached; rank 0 gathers."""
    from ..filters.nlmeans import nlmeans_plane
    rows = tile_rows(H, mesh.tile)
    starts = [sum(rows[:t]) for t in range(mesh.tile)]
    w = mesh.world
    if mesh.rank == 0:
        refs = refs.to(mesh.device)
        sends = [(m, refs[:, starts[m]:starts[m] + rows[m]])
                 for m in range(1, mesh.n)]
        w.exchange(sends)
        mine = refs[:, :rows[0]]
    else:
        mine = w.exchange(recvs=[(0, (T, rows[mesh.rank], W), dtype)])[0]
    halo = cfg["rng"] + cfg["patch"]
    region, above, _below = _halo_pad(mesh, mine, halo, rows)
    out = nlmeans_plane(region[0], region, **cfg)[above:above + len(mine[0])]
    if mesh.rank != 0:
        w.exchange([(0, out)])
        return None
    got = w.exchange(recvs=[(m, (rows[m], W), out.dtype)
                            for m in range(1, mesh.n)])
    return torch.cat([out] + got)


def tile_shard_nlmeans(mesh: Mesh, *, strength=6.0, origin_tune=0.9,
                       patch=7, rng=3, maxval=255):
    """nlmeans_plane over the mesh's tile axis: fn(cur, refs) on rank 0,
    cur (H, W), refs (T, H, W) with refs[0] == cur, on rank 0's device.
    Each rank filters a row tile with a halo of rng + patch rows from its
    neighbours, which covers the filter's reach, so the output equals the
    untiled filter bit for bit, the picture's edge rows included.  Tiles
    are ceil(H / n) rows and H need not divide; a plane whose tiles
    cannot hold the halo runs untiled on rank 0."""
    from ..filters.nlmeans import nlmeans_plane
    cfg = dict(strength=strength, origin_tune=origin_tune, patch=patch,
               rng=rng, maxval=maxval)

    if mesh.shape["gop"] != 1:
        raise ValueError("nlmeans tiles take a mesh of one gop row")

    def fn(cur, refs):
        T, H, W = (int(s) for s in refs.shape)
        if mesh.n == 1 or not tiles_fit(H, mesh.tile, rng + patch):
            return nlmeans_plane(cur, refs, **cfg)
        return mesh.run(_nlmeans_item, T, H, W, refs.dtype, cfg, root=refs)
    return fn

