"""Run a function on W ranks of this host in spawned processes: what
``torchrun`` does for a script, for a library call.

    spawn_ranks(fn, 2, args=(out_dir,), backend="gloo", device="cpu")

Each process gets the ``torchrun`` environment (RANK, WORLD_SIZE,
LOCAL_RANK, and MASTER_ADDR and MASTER_PORT on localhost), joins the group
through ``mesh.init_from_env`` and calls ``fn(*args)``. A ``device`` with
a card's index puts every rank on that card (two ranks on one card need
gloo; NCCL refuses them). ``fn`` must be a module-level function, which a
spawned process can import. Raises if a rank exits non-zero or if the
ranks outlast ``timeout`` seconds, which also bounds each collective.
"""

import multiprocessing
import os
import socket
import time

import torch

from gangealing_torch.parallel.mesh import init_from_env, shutdown


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, args, rank, world, port, backend, device, timeout):
    index = torch.device(device).index
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank if index is None else index),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    init_from_env(backend=backend, device=device, timeout=timeout)
    try:
        fn(*args)
    finally:
        shutdown()


def spawn_ranks(fn, world, args=(), backend="gloo", device="cpu",
                timeout=120.0):
    """Run ``fn(*args)`` on ``world`` ranks; return when all have ended."""
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(
        fn, args, r, world, port, backend, device, timeout))
        for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        if hung:
            raise TimeoutError(f"ranks {hung} still ran after {timeout} s")
        failed = {r: p.exitcode for r, p in enumerate(procs)
                  if p.exitcode != 0}
        if failed:
            raise RuntimeError(f"ranks exited non-zero: {failed}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
