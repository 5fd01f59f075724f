"""Spawning the ranks of one machine.

``run_ranks`` starts one process per rank (``torch.multiprocessing``,
start method ``spawn``), joins each to the process group, calls the given
function there and brings its return value back.  It waits until a
deadline: a rank that raises, dies or outlives the deadline ends every
rank, and the parent raises with the rank's traceback, so a failed rank
never leaves the others blocked in a collective.
"""

from __future__ import annotations

import queue as queue_mod
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.multiprocessing as mp

from coponerf_tpu_torch.parallel.mesh import DEFAULT_TIMEOUT_S, init_distributed


def _rank_main(rank: int, world_size: int, backend: str, init_method: str, device, threads: Optional[int],
               timeout_s: float, fn: Callable, args: Sequence, results) -> None:
    import torch.distributed as dist

    if threads:
        torch.set_num_threads(threads)
    try:
        init_distributed(backend, rank, world_size, init_method, device=device, timeout_s=timeout_s)
        try:
            out = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world_size: int, backend: str, init_method: str, args: Sequence = (),
              devices: Optional[Sequence] = None, threads: Optional[int] = None, deadline_s: Optional[float] = 600.0,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> List[Any]:
    """``[fn(rank, world_size, *args) for each rank]``, each in its own
    process, joined to a ``backend`` group at ``init_method`` (a
    ``file://`` path that no other run uses, or ``tcp://localhost:PORT``),
    on ``devices[rank]`` where given, with ``threads`` CPU threads.  ``fn``
    must be importable by name (a module-level function) and return
    picklable values (numpy arrays, not tensors).  Raises ``RuntimeError``
    with the traceback of the first rank that fails and ``TimeoutError``
    after ``deadline_s`` (None: no deadline); in both cases every rank is
    killed first."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = []
    for rank in range(world_size):
        device = None if devices is None else devices[rank]
        p = ctx.Process(target=_rank_main, args=(rank, world_size, backend, init_method, device, threads, timeout_s,
                                                 fn, tuple(args), results))
        p.start()
        procs.append(p)
    got = {}
    end = time.monotonic() + (float("inf") if deadline_s is None else deadline_s)
    try:
        while len(got) < world_size:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue_mod.Empty:
                if time.monotonic() > end:
                    raise TimeoutError(f"{world_size - len(got)} of {world_size} ranks did not finish in "
                                       f"{deadline_s:.0f} s") from None
                dead = [r for r, p in enumerate(procs) if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} died with exit code {procs[dead[0]].exitcode}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=max(1.0, min(60.0, end - time.monotonic())))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
    return [got[r] for r in range(world_size)]
