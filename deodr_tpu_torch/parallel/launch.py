"""Starting the SPMD ranks of :mod:`deodr_tpu_torch.parallel.sharding`.

``run_ranks(fn, world_size, args)`` spawns ``world_size`` processes, joins
them into one process group (``file://`` rendezvous in a temporary
directory, a timeout of ``TIMEOUT_S`` so that a hung collective fails the
run instead of waiting gloo's 30 minutes), calls ``fn(rank, world_size,
*args)`` on each and returns the results in rank order. A rank that raises
makes ``run_ranks`` raise (``torch.multiprocessing.spawn`` ends the other
ranks); nothing falls back to fewer processes. ``device`` defaults to
``cuda``, as the port's other entry points do: asking for it where
``torch.cuda.is_available()`` is false raises before any rank is spawned,
and the CPU takes ``device="cpu"``. On ``cuda`` the parent
builds the kernels before any rank starts, so that no two ranks compile
into the build directory at once; rank ``r`` uses card ``r % device_count``
(every rank shares the one card of a one-card machine, where the process
group must be gloo: NCCL refuses two ranks on one card).
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
from typing import Callable, Optional

import torch
import torch.distributed as dist

from deodr_tpu_torch.scene import _device

# a collective that waits longer than this fails the run (gloo's default is 30 minutes)
TIMEOUT_S = 180


def init_process_group(rank: int, world_size: int, init_method: str, backend: str = "gloo") -> None:
    """``torch.distributed.init_process_group`` with an explicit address,
    world size and rank, and a timeout of ``TIMEOUT_S``."""
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))


def _rank_main(rank, fn, world_size, init_method, backend, device, threads, out_dir, args):
    if threads is not None:
        torch.set_num_threads(threads)
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    init_process_group(rank, world_size, init_method, backend)
    try:
        result = fn(rank, world_size, *args)
        if device == "cuda":
            torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_ranks(fn: Callable, world_size: int, args: tuple = (), backend: str = "gloo", device: Optional[str] = None,
              threads: Optional[int] = None) -> list:
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` spawned ranks of
    one process group → their results (picklable; numpy arrays travel
    best) in rank order. ``fn`` must be importable by name (a module-level
    function). ``device`` is ``"cuda"`` (the default) or ``"cpu"``;
    ``threads`` sets each rank's PyTorch intra-op threads."""
    import torch.multiprocessing as mp

    device = _device(device).type
    if device == "cuda":
        from deodr_tpu_torch.ops import kernels

        kernels.build()
    with tempfile.TemporaryDirectory(prefix="deodr_ranks_") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        mp.spawn(_rank_main, args=(fn, world_size, init_method, backend, device, threads, tmp, args),
                 nprocs=world_size, join=True)
        results = []
        for rank in range(world_size):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
