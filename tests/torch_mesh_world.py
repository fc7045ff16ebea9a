"""Worlds of the port's ranks on one host for the tests, held to a hard
time limit.

``spawn`` starts n ranks as processes of their own (``multiprocessing``
spawn, never fork: the test process runs threads), with a rendezvous
through a file, runs a list of ``Call``s on rank 0 while the other ranks
serve its work items (``parallel/mesh.py``), and returns rank 0's
results.  It watches its processes: when a rank fails, or the time limit
passes, it kills every rank and raises ``RankFailed`` naming the rank and
the end of its log, with the ranks' pids.  The ranks import this module
by name: the spawned interpreters take the test process's ``sys.path``,
which holds ``tests/``.

    spawn(2, [Call("handbrake_tpu_torch.parallel.gop:encode_gop_parallel",
                   (frames, 96, 64, 28, 4), {"device": "cpu"})],
          workdir=tmp, limit_s=60, device="cpu")
"""
from __future__ import annotations

import importlib
import os
import pickle
import time
from dataclasses import dataclass, field

from handbrake_tpu_torch.parallel.launch import RankFailed


@dataclass
class MeshSpec:
    """An argument of a Call that rank 0 replaces by make_mesh(n, tile)
    on the world's device."""
    n: int
    tile: int = 1


@dataclass
class Call:
    """fn ("module:function") called on rank 0 with args and kwargs (a
    MeshSpec among them made into a mesh); when `then` is given, the
    result is called with `then` in turn (a factory such as tile_smooth)."""
    fn: str
    args: tuple = ()
    kwargs: dict = field(default_factory=dict)
    then: tuple | None = None

    def __call__(self):
        from handbrake_tpu_torch.parallel.mesh import current_world, make_mesh

        def arg(a):
            if isinstance(a, MeshSpec):
                return make_mesh(a.n, tile=a.tile,
                                 device=current_world().device)
            return a
        mod, name = self.fn.split(":")
        out = getattr(importlib.import_module(mod), name)(
            *map(arg, self.args), **{k: arg(v)
                                     for k, v in self.kwargs.items()})
        return out(*self.then) if self.then is not None else out


def _rank_main(rank, nprocs, workdir, device, calls, timeout_s, env):
    """One rank: join the world; rank 0 runs the calls and writes their
    results, the others serve."""
    log = os.open(os.path.join(workdir, f"rank{rank}.log"),
                  os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    os.dup2(log, 1)
    os.dup2(log, 2)
    # before CUDA starts, which reads CUDA_VISIBLE_DEVICES once
    os.environ.update(env or {}, RANK=str(rank), WORLD_SIZE=str(nprocs),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(nprocs))
    import torch
    if device == "cpu":
        torch.set_num_threads(1)

    from handbrake_tpu_torch.parallel.mesh import init_world
    world = init_world(device, init_method="file://" + os.path.join(
        workdir, "rendezvous"), rank=rank, world_size=nprocs,
        timeout_s=timeout_s)
    if rank != 0:
        world.serve()
        return
    results = [c() for c in calls]
    with open(os.path.join(workdir, "results.pkl"), "wb") as f:
        pickle.dump(results, f)
    world.close()


def _tail(path: str, n: int = 3000) -> str:
    try:
        with open(path, errors="replace") as f:
            return f.read()[-n:]
    except OSError:
        return ""


def spawn(nprocs: int, calls: list, *, workdir: str, limit_s: float,
          device=None, timeout_s: float = 60.0, env=None) -> list:
    """Run `calls` on rank 0 of a fresh world of nprocs ranks on
    `device` (None: the CUDA card, which raises where there is none;
    "cpu" runs on the CPU; on cards the ranks share them as
    ``utils/device.py`` deals them), each rank's environment updated by
    `env` (CUDA_VISIBLE_DEVICES, say), its process group's timeout
    timeout_s.  Each rank logs to ``workdir/rank<r>.log``.  Raises
    RankFailed when a rank exits with an error or the ranks are not done
    within limit_s; no process outlives the call."""
    import multiprocessing as mp

    from handbrake_tpu_torch.utils.device import resolve_device
    device = resolve_device(device).type
    os.makedirs(workdir, exist_ok=True)
    for name in ("rendezvous", "results.pkl"):
        if os.path.exists(os.path.join(workdir, name)):
            os.remove(os.path.join(workdir, name))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                         args=(r, nprocs, workdir, device,
                               calls if r == 0 else None, timeout_s, env))
             for r in range(nprocs)]
    deadline = time.monotonic() + limit_s
    try:
        for p in procs:
            p.start()
        pids = [p.pid for p in procs]
        while True:
            codes = [p.exitcode for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                raise RankFailed(_failure(workdir, failed, codes), pids)
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                running = [r for r, c in enumerate(codes) if c is None]
                raise RankFailed(
                    f"ranks {running} still running after {limit_s} s; "
                    + _failure(workdir, running, codes), pids)
            time.sleep(0.02)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            if p.pid is not None:
                p.join()
    with open(os.path.join(workdir, "results.pkl"), "rb") as f:
        return pickle.load(f)


def _failure(workdir, ranks, codes) -> str:
    return "; ".join(f"rank {r} (exit {codes[r]}): "
                     + _tail(os.path.join(workdir, f"rank{r}.log"))
                     for r in ranks)


def handle_job_failing_on_rank_zero(job, device):
    """Rank 0: ``hb.Handle`` runs a GOP-parallel job whose work item fails
    here, at its GOPs' first P frames, while rank 1 waits mid-item for
    the frames of its next step.  Then this process lives on, as an
    application that holds a Handle does, until the world ends it."""
    from handbrake_tpu_torch import hb
    from handbrake_tpu_torch.codecs.h264.encoder import H264Encoder

    def fail(*_a, **_k):
        raise RuntimeError("the entropy coder failed on rank 0")
    H264Encoder.encode_p_from_analysis = fail
    h = hb.Handle(device=device)
    h.add(job)
    h.start()
    h.work_wait()
    time.sleep(600)
    return repr(h.work_exception)
