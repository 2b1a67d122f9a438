"""Start the ranks of a multi-process run from Python, as the tests and
``chip_smoke.py`` do (a user's run starts them with ``python -m
torch.distributed.run``; see ``repro_torch.launch.train``).

:func:`run_ranks` starts one process per rank with the ``spawn`` method,
joins them to one process group over a file rendezvous (no TCP port, so
several runs may start at once), calls ``fn(rank, world, *args)`` in each,
and returns each rank's result.  A child's exception is raised in the
caller (``torch.multiprocessing`` re-raises it with the child's traceback)
and stops the others; a run that outlasts its time limit is killed and
raises ``TimeoutError``.  No process outlives the call.

The arguments reach the ranks through a file (``torch.save``), not the
pipe that starts each process: the parent writes a child's start-up data
into that pipe and waits until the child has read it, which the child does
only after its interpreter has imported torch, so arguments of more than
the pipe's buffer made the ranks start one after the other.
"""

from __future__ import annotations

import os
import tempfile
import time
from pathlib import Path
from typing import Callable, Optional

import torch
import torch.multiprocessing as mp

from repro_torch.distributed import comm


def _child(rank: int, fn: Callable, world: int, backend: str, store: str, out_dir: str,
           group_timeout_s: float) -> None:
    import torch.distributed as dist

    args = torch.load(os.path.join(out_dir, "args.pt"), weights_only=False)
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    comm.init_group(backend, f"file://{store}", rank, world, group_timeout_s)
    try:
        result = fn(rank, world, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, args: tuple = (), *, backend: str = "gloo",
              timeout_s: float = 600.0, group_timeout_s: float = comm.DEFAULT_TIMEOUT_S,
              work_dir: Optional[str] = None) -> list:
    """``[fn(0, world, *args), ..., fn(world - 1, world, *args)]``, each run
    in its own process in one process group.  ``fn`` must be importable
    (a module-level function) and its result picklable by ``torch.save``.
    ``backend="nccl"`` puts rank r on ``cuda:r``."""
    with tempfile.TemporaryDirectory(dir=work_dir) as d:
        torch.save(args, os.path.join(d, "args.pt"))
        ctx = mp.start_processes(
            _child, args=(fn, world, backend, os.path.join(d, "store"), d, group_timeout_s),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{world} ranks did not finish within {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(Path(d) / f"rank{r}.pt", weights_only=False) for r in range(world)]

