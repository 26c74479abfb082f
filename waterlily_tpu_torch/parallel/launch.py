"""Start a `torch.distributed` world and run a function on every rank.

    results = run_ranks(fn, world=8, backend="gloo", device="cuda",
                        timeout=120.0, args=(...))

Each rank is a process started with the ``spawn`` method (the caller may
already hold a CUDA context, which a forked child cannot use), with one
CPU thread (`torch.set_num_threads(1)`: a CPU reduction's order depends on
the thread count), a file store under a temporary directory, and
``init_process_group``'s ``timeout``.  It calls ``fn(rank, world, device,
*args)`` and sends back what ``fn`` returns (picklable: ``fn`` must be a
module-level function); ``device`` is the card unless the caller asks
for another (``"cpu"``).  The parent collects the results while it
waits, up to ``timeout`` seconds in all; a rank that raises, dies or is
still running then fails the run: every child is killed and
`RuntimeError` raised (`TimeoutError` for a hang), so a hung rank never
outlives its limit.

On CUDA each rank takes card ``rank % device_count`` (NCCL wants one
rank a card; several gloo ranks share a card) unless ``device`` names
one.  A world that ``torchrun`` started (``RANK`` and ``WORLD_SIZE`` in
the environment) is used as it is: this process runs its own rank of
``fn`` and the list holds its result only.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue as queue_mod
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

__all__ = ["run_ranks"]


def _torchrun_world():
    """``(rank, world)`` of a world that ``torchrun`` started, or None."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    return None


def _rank_device(device, rank: int) -> torch.device:
    """The device of ``rank``: ``device`` itself off CUDA or where it names
    a card, else card ``rank % device_count``."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


def _init(backend, rank, world, device, init_method, timeout):
    dev = _rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    return dev


def _rank_main(fn, rank, world, backend, device, init_method, timeout, args,
               results):
    torch.set_num_threads(1)
    try:
        dev = _init(backend, rank, world, device, init_method, timeout)
        try:
            out = fn(rank, world, dev, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:  # noqa: BLE001 - reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world: int, backend: str = "gloo", device="cuda",
              timeout: float = 300.0, args: tuple = ()) -> list:
    """``fn(rank, world, device, *args)`` on ``world`` ranks of a new
    process group (module doc); the ranks' results in rank order."""
    tr = _torchrun_world()
    if tr is not None:
        rank, world = tr
        torch.set_num_threads(1)
        dev = _init(backend, rank, world, device, "env://", timeout)
        try:
            return [fn(rank, world, dev, *args)]
        finally:
            dist.destroy_process_group()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="wl_ranks_") as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world, backend, device,
                                   init_method, timeout, args, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        got, failed = {}, []
        deadline = time.monotonic() + timeout
        try:
            while len(got) + len(failed) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    rank, ok, out = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    # a rank that died without a word (killed, out of
                    # memory) fails the run at once
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and not p.is_alive()
                            and p.exitcode not in (0, None)]
                    if dead:
                        failed += [(r, f"exit code {procs[r].exitcode}")
                                   for r in dead]
                        break
                    continue
                if ok:
                    got[rank] = out
                else:
                    failed.append((rank, out))
                    break
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(10)
            results.close()
    if failed:
        raise RuntimeError(f"{len(failed)} of {world} ranks failed:\n"
                           + "\n".join(f"rank {r}: {msg}"
                                       for r, msg in failed))
    if len(got) < world:
        missing = sorted(set(range(world)) - set(got))
        raise TimeoutError(f"ranks {missing} of {world} did not finish in "
                           f"{timeout:g} s")
    return [got[r] for r in range(world)]
