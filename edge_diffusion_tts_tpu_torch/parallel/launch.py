"""Run a function on N local ranks, each a process in one process group.

``spawn(fn, nprocs, args)`` starts ``nprocs`` processes with the ``spawn``
start method.  Each initializes the default group over a TCP store on
127.0.0.1 (a free port picked here) with the backend asked for, runs
``fn(rank, *args)``, writes what it returns (pickled) to a file the parent
reads, and tears the group down.  The parent joins every rank under one
deadline: a rank that exits non-zero (its traceback is re-raised here) or a
deadline that passes kills every rank still running and raises, so a rank
that dies never leaves the others blocked in a collective.

``fn`` must be importable by name (a module-level function): the children
start from a fresh import.  On a multi-node cluster use ``torchrun`` and
``multihost.init_multihost`` instead.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import shutil
import socket
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, nprocs: int, port: int, backend: str, threads: Optional[int],
               timeout_s: float, out_dir: str, args: tuple) -> None:
    import torch
    import torch.distributed as dist

    # The ranks are local: bootstrap and transport over loopback.
    os.environ.setdefault("GLOO_SOCKET_IFNAME" if backend == "gloo" else "NCCL_SOCKET_IFNAME",
                          "lo")
    if threads:
        torch.set_num_threads(threads)
    try:
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=nprocs,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            result = fn(rank, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    with open(os.path.join(out_dir, f"rank{rank}.pkl.tmp"), "wb") as f:
        pickle.dump(result, f)
    os.replace(os.path.join(out_dir, f"rank{rank}.pkl.tmp"),
               os.path.join(out_dir, f"rank{rank}.pkl"))


def spawn(fn: Callable, nprocs: int, args: Sequence[Any] = (), backend: str = "gloo",
          timeout: float = 300.0, threads: Optional[int] = None) -> List[Any]:
    """``[fn(0, *args), ..., fn(nprocs - 1, *args)]``, each run on its own
    rank.  ``threads`` sets each rank's torch intra-op threads.  Raises
    RuntimeError when a rank fails and TimeoutError when ``timeout`` seconds
    pass before every rank has finished."""
    ctx = mp.get_context("spawn")
    out_dir = tempfile.mkdtemp(prefix="edt_spawn_")
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, nprocs, port, backend, threads, timeout, out_dir,
                               tuple(args)))
             for r in range(nprocs)]
    started = []
    try:
        for p in procs:
            p.start()
            started.append(p)
        deadline = time.monotonic() + timeout
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if not p.is_alive() and p.exitcode != 0]
            if failed:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__} on {nprocs} ranks did not finish in "
                                   f"{timeout:g} s")
            time.sleep(0.05)
        for p in procs:
            p.join(timeout=1.0 if any(q.exitcode not in (0, None) for q in procs) else 30.0)
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            errs = []
            for r, code in bad:
                path = os.path.join(out_dir, f"rank{r}.err")
                if os.path.exists(path):
                    with open(path) as f:
                        errs.append(f"--- rank {r} (exit {code}) ---\n{f.read()}")
            detail = "\n".join(errs) or f"exit codes {bad}"
            raise RuntimeError(f"{fn.__name__} failed on {nprocs} ranks:\n{detail}")
        results = []
        for r in range(nprocs):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in started:
            if p.is_alive():
                p.kill()
        for p in started:
            p.join(timeout=10.0)
        shutil.rmtree(out_dir, ignore_errors=True)
