"""``torchrun`` under a hard time limit.

``torchrun`` runs a command under ``python -m torch.distributed.run
--standalone`` (a free local port) in a session of its own, and kills
every process of that session when it returns or when the time limit
passes; then it raises ``RankFailed`` with the end of the output.

    from handbrake_tpu_torch.parallel.launch import torchrun
    rc, out = torchrun(2, ["-m", "handbrake_tpu_torch.cli", "-i", "in.y4m",
                           "-o", "out.mp4", "--gop-parallel", "4"],
                       limit_s=600)
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys


class RankFailed(RuntimeError):
    """A world of ranks that failed or outlasted its limit; ``pids`` are
    the processes it started, all ended when this is raised."""

    def __init__(self, msg: str, pids=()):
        super().__init__(msg)
        self.pids = list(pids)


def torchrun(nprocs: int, argv: list, *, limit_s: float, env=None,
             cwd=None) -> tuple:
    """Run ``python -m torch.distributed.run --standalone
    --nproc-per-node nprocs <argv>`` (argv: a script and its arguments,
    or ``-m module ...``) in a session of its own; (exit code, output).
    Raises RankFailed when it outlasts limit_s; the session's processes
    are killed either way."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={nprocs}", *argv]
    p = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True,
                         start_new_session=True, env=env, cwd=cwd)
    try:
        out, _ = p.communicate(timeout=limit_s)
    except subprocess.TimeoutExpired as e:
        _kill_session(p)
        out = (e.output or b"")
        out = out.decode(errors="replace") if isinstance(out, bytes) else out
        raise RankFailed(f"torchrun still running after {limit_s} s:\n"
                         f"{out[-3000:]}", [p.pid]) from None
    finally:
        _kill_session(p)
    return p.returncode, out


def _kill_session(p):
    try:
        os.killpg(p.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass
    p.wait()
