"""Starting a world of ranks: ``init_distributed`` for a process that
``torchrun`` started (the CLIs), and ``spawn`` for a world started from
Python (the tests and chip_smoke.py).

Backend: NCCL when every rank has its own card; gloo when the ranks of a
host share cards (``LOCAL_WORLD_SIZE > torch.cuda.device_count()``: NCCL
refuses two ranks on one device), which is said on stdout; gloo on the
CPU. ``torch.distributed`` learns of no cluster by itself: torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``...)
or ``spawn``'s ``file://`` store in a temporary directory gives it the
world.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

# seconds a collective may wait: the other ranks wait for rank 0's eval of
# the whole validation set (ft1, the sliding window) between epochs
DEFAULT_TIMEOUT = 4 * 3600.0


@dataclass(frozen=True)
class World:
    """This process's rank in a started world and its device."""

    rank: int
    size: int
    local_rank: int
    backend: str
    device: torch.device
    owned: bool         # whether init_distributed started the group


def pick_backend(device_type: str, local_world: int, cards: int) -> str:
    """nccl when each of the host's `local_world` ranks has its own card,
    else gloo (shared cards, or the CPU)."""
    if device_type == "cuda" and local_world <= cards:
        return "nccl"
    return "gloo"


def init_distributed(device: str = "cuda",
                     timeout: float = DEFAULT_TIMEOUT) -> Optional[World]:
    """The world of this process: the one already initialized (``spawn``),
    or torchrun's from the environment; None for a single process (no
    ``WORLD_SIZE`` above 1), which then runs as before. On CUDA the device
    is ``cuda:LOCAL_RANK``, or LOCAL_RANK modulo the card count when ranks
    share cards."""
    dev_type = torch.device(device).type
    owned = not dist.is_initialized()
    if owned:
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return None
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                         os.environ["WORLD_SIZE"]))
        cards = torch.cuda.device_count() if dev_type == "cuda" else 0
        if dev_type == "cuda" and cards == 0:
            raise RuntimeError("no CUDA GPU is available; pass --device cpu "
                               "to run the ranks on the CPU")
        backend = pick_backend(dev_type, local_world, cards)
        if dev_type == "cuda" and backend == "gloo":
            print(f"{local_world} ranks share {cards} card(s): backend gloo "
                  "(NCCL takes one rank a card)", flush=True)
        dist.init_process_group(
            backend, init_method="env://",
            timeout=datetime.timedelta(seconds=timeout))
    rank, size = dist.get_rank(), dist.get_world_size()
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if dev_type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    return World(rank, size, local_rank, dist.get_backend(), dev, owned)


def _numpy(v):
    """Tensors in a result as numpy arrays (what crosses the queue)."""
    if torch.is_tensor(v):
        return v.detach().cpu().numpy()
    if isinstance(v, dict):
        return {k: _numpy(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_numpy(x) for x in v)
    return v


def _child(fn, rank, world, backend, store, timeout, threads, env, out,
           args):
    os.environ.update(env)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(threads)
    try:
        dist.init_process_group(
            backend, init_method=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            res = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, _numpy(res)))
    except BaseException:  # reported to the parent, which raises
        out.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn: Callable, world: int, *, backend: str = "gloo",
          timeout: float = 120.0, args: Sequence[Any] = (),
          threads: int = 1, env: Optional[dict] = None) -> List[Any]:
    """Run ``fn(rank, world, *args)`` in `world` fresh processes (the
    ``spawn`` start method; `fn` is pickled by import path) joined in one
    process group of `backend`, whose store is a ``file://`` in a new
    temporary directory (no port, so concurrent worlds never collide).
    Each rank runs at `threads` threads with `env` set. Returns the ranks'
    results in rank order (tensors as numpy arrays). A rank that raises,
    dies or is still running `timeout` seconds after the start fails the
    call: every child is killed and RuntimeError (TimeoutError) names the
    rank and its traceback."""
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="vaeseg-world-")
    store = "file://" + os.path.join(tmp, "store")
    out = ctx.Queue()
    procs = [ctx.Process(target=_child, daemon=True,
                         args=(fn, r, world, backend, store, timeout, threads,
                               dict(env or {}), out, tuple(args)))
             for r in range(world)]
    results, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(results) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"spawn: ranks {sorted(set(range(world)) - set(results))}"
                    f" of {world} did not finish within {timeout} s")
            try:
                rank, ok, val = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and not p.is_alive()
                        and p.exitcode not in (None, 0)]
                if dead and not errors:
                    # a rank died without reporting (killed, crashed): the
                    # others would wait on it until the timeout
                    errors.append((dead[0], f"exit code "
                                   f"{procs[dead[0]].exitcode}"))
                    break
                continue
            if ok:
                results[rank] = val
            else:
                errors.append((rank, val))
                break
        if errors:
            rank, tb = errors[0]
            raise RuntimeError(f"spawn: rank {rank} of {world} failed:\n{tb}")
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
        return [results[r] for r in range(world)]
    finally:
        started = [p for p in procs if p.pid is not None]
        for p in started:
            if p.is_alive():
                p.kill()
        for p in started:
            p.join(timeout=5.0)
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
