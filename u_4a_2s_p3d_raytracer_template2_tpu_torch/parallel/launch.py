"""Start the ranks of a process group on one host and collect what each
returns.

``run(fn, n, *args)`` spawns n processes (the ``spawn`` start method: no
forked CUDA context or threads), each of which joins a ``torch.distributed``
group of n ranks through a ``file://`` rendezvous in a temporary directory
(no port to collide with another run on the host), calls ``fn(rank, n,
*args)`` and saves its result with ``torch.save``. Rank r gets
``LOCAL_RANK=r``; on NCCL it runs on ``cuda:r`` (``dist.rank_device``),
made current and bound to the group, and a run of more NCCL ranks than
the host has cards raises before anything is spawned (NCCL refuses two
ranks on one device); gloo ranks use whatever device ``fn`` picks. A
rank joins through ``dist.join_group`` and leaves through
``dist.leave_group``. The parent waits at
most ``timeout_s`` seconds for all of them: a rank that fails makes it kill the
others at once and raise with the rank's traceback, and a run that outlasts
the timeout is killed and raises ``TimeoutError``; the group's own timeout
bounds a rank that waits on a collective. ``fn`` must be importable by name
(a module-level function) and its module must not import what the ranks
should not load; its result is loaded back on the parent with tensors on
the devices they were saved from.
"""
from __future__ import annotations

import multiprocessing
import multiprocessing.connection
import os
import tempfile
import time
import traceback
from pathlib import Path

import torch

# how long a run may take before its ranks are killed, and the group's
# timeout on the rendezvous and on each collective
TIMEOUT_S = 120.0


def _rank_main(fn, rank: int, size: int, init_method: str, backend: str,
               timeout_s: float, out_dir: str, args: tuple) -> None:
    from .dist import join_group, leave_group, rank_device

    out = Path(out_dir)
    # the ranks share one host: gloo's pairs connect over the loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ["LOCAL_RANK"] = str(rank)
    try:
        # NCCL: cuda:r; gloo: the CPU here, the card each rank's fn names
        dev = rank_device(None, "nccl") if backend == "nccl" else "cpu"
        join_group(backend, init_method, size, rank, dev, timeout_s)
        torch.save(fn(rank, size, *args), out / f"rank{rank}.pt")
    except BaseException:
        # written before the group closes: the other ranks' collectives
        # fail once it does, and the first traceback names the cause
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise SystemExit(1)
    finally:
        leave_group()


def _failure(procs, out: Path) -> str:
    """The report of a failed run: the rank whose traceback was written
    first (the others' collectives fail after it), its traceback, and the
    exit codes of every rank that has stopped."""
    errs = sorted((p.stat().st_mtime_ns, int(p.stem[4:]))
                  for p in out.glob("rank*.err"))
    codes = {r: p.exitcode for r, p in enumerate(procs)
             if p.exitcode is not None}
    if not errs:
        return (f"ranks exited with codes {codes} of {len(procs)} and wrote "
                "no traceback")
    first = errs[0][1]
    return (f"rank {first} of {len(procs)} failed first; exit codes "
            f"{codes}:\n{(out / f'rank{first}.err').read_text()}")


def run(fn, n: int, *args, backend: str = "gloo",
        timeout_s: float = TIMEOUT_S) -> list:
    """``fn(rank, n, *args)`` on n spawned ranks of one ``backend`` group;
    returns their results in rank order. Raises ``RuntimeError`` if a rank
    fails (with its traceback) and ``TimeoutError`` if the run outlasts
    ``timeout_s`` seconds; no rank is left running either way. Raises
    ``RuntimeError`` before spawning when ``backend`` is NCCL and n exceeds
    the host's cards."""
    if backend == "nccl" and n > torch.cuda.device_count():
        raise RuntimeError(
            f"{n} NCCL ranks need {n} cards, one a rank; this host has "
            f"{torch.cuda.device_count()} (NCCL refuses two ranks on one "
            "device: use gloo to share a card)")
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="rt_ranks_") as tmp:
        init = f"file://{tmp}/rendezvous"
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, n, init, backend, timeout_s, tmp,
                                   args), name=f"rank{r}")
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            pending = dict(enumerate(procs))
            while pending:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"ranks {sorted(pending)} of {n} still running after "
                        f"{timeout_s:g} s")
                multiprocessing.connection.wait(
                    [p.sentinel for p in pending.values()], timeout=left)
                for r, p in list(pending.items()):
                    if not p.is_alive():
                        p.join()
                        del pending[r]
                if any(p.exitcode for p in procs if not p.is_alive()):
                    raise RuntimeError(_failure(procs, Path(tmp)))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(Path(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(n)]
