"""Traffic of kind "train_ranks": the training loop's body data-parallel
over ``world`` ranks, one card each, as trainers run the recipes.

The harness process is rank 0 on its card; ranks 1..W-1 are processes it
spawns, one card each (``cuda:<rank>``), under the ``torchrun``
environment that ``gangealing_torch/parallel/launch.py`` sets (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT on localhost). Each rank
builds the same seeded state while the others do, then joins the group
through ``mesh.init_from_env`` (NCCL on cards, gloo on the CPU) with its
timeout on, so that a rank that hangs ends the run in an error.

Every rank is a ``train.TrainCell`` at the global batch ``world *
batch``: the same weights, the same loop body, the same checked passes
and reset. A unit is one iteration of the global batch; each rank draws
that iteration's z and noise for the global batch, as ``train.Inputs``
does for one card, and steps on its slice, images [r*b, (r+1)*b). The
program all-reduces the gradients and the logged terms itself.

The ranks keep step as torchrun's trainers do: through the program's
all-reduce on the card and its host read every ``log_every`` units. Rank
0 tells the others over a gloo group of the host, at the start of each
block of ``log_every`` window units, that such a block follows; that a
traced series of ``trace_units`` units begins (``TRACE``: every rank
profiles the same units and the ranks agree on retaking a window); or
that the window has closed (``END``). Rank 0 finishes the window's last
block after the window, untimed, so that every rank runs the same units.
The signal adds no collective on the card beyond the program's own. After
``END`` every rank runs the checked passes again from the seeded state,
and the other ranks send rank 0 their peak memory, their traced busy
seconds, their count of units and the forbidden modules they hold
(``run.forbidden_modules``), and exit; rank 0 then runs the reference
alone, the single-card reference at the global batch, taken in chunks of
one rank's share: the counters of a traced run (``TrainCell._counted``)
are of its first chunk, rank 0's images.

On the card each spawned rank runs with ``OMP_NUM_THREADS`` 1, and rank
0 with one intra-op thread, as torchrun sets several processes of a node.
"""

import atexit
import contextlib
import datetime
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch
import torch.distributed as dist

from gangealing_torch.parallel import mesh
from gangealing_torch.parallel.launch import free_port

from portbench import run, trace
from portbench.drivers import train

ROOT = Path(__file__).resolve().parents[2]
TRACE, END = -1, 0  # signals; a count above 0 is a block of units
TIMEOUT_S = 120.0  # bounds every collective, on the card and on the host
CPU_THREADS = 2  # a rank's torch threads on the CPU (the tests)
# the fault (a name in portbench.faults.FAULTS) that the ranks spawned
# next are to run under; set by the faults themselves
FAULT = None


class RanksCell(train.TrainCell):
    """One rank's training state and loop body; on rank 0 also the other
    ranks' processes, and the check."""

    def __init__(self, cfg, traffic, seed, device, parts,
                 compute_dtype="float32", rank=0, port=None):
        self.world, self.rank = traffic["world"], rank
        self.share = traffic["batch"]
        self.heads = cfg["stn"]["num_heads"]
        self.port = port or free_port()
        self.seed, self.compute_dtype = seed, compute_dtype
        self.procs, self.peers, self.following = [], [], False
        self.units = 0  # of the window and the traced series
        self.left = 0  # rank 0: units left of the block last signalled
        self.series = False  # rank 0: in a traced series
        self.host, self.sent = None, None
        super().__init__(cfg, dict(traffic, batch=self.world * self.share,
                                   reference_chunk=self.share),
                         seed, device, parts, compute_dtype)
        self.following = True

    def build_state(self, seed, parts, compute_dtype):
        if self.rank == 0 and self.world > 1:
            if self.device.type == "cuda":
                torch.set_num_threads(1)
            t0 = time.perf_counter()
            self.spawn(self.traffic)
            parts["ranks spawned"] = time.perf_counter() - t0
        super().build_state(seed, parts, compute_dtype)
        t0 = time.perf_counter()
        self.join()
        parts["process group"] = time.perf_counter() - t0

    def spawn(self, traffic):
        """Ranks 1..W-1, each a process of its own (``python -m
        portbench.drivers.train_ranks <rank> <job>``) with this process's
        caches (``run.cache_env``); ended at this process's exit if still
        running."""
        env = dict(os.environ)
        if self.device.type == "cuda":
            env["OMP_NUM_THREADS"] = "1"
        if sys.pycache_prefix:
            env["PYTHONPYCACHEPREFIX"] = sys.pycache_prefix
        job = json.dumps({"port": self.port, "cfg": self.cfg,
                          "traffic": dict(traffic, batch=self.share),
                          "seed": self.seed, "device": self.device.type,
                          "compute_dtype": self.compute_dtype,
                          "fault": FAULT})
        for r in range(1, self.world):
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", "portbench.drivers.train_ranks",
                 str(r), job], cwd=ROOT, env=env))
        atexit.register(self.kill_ranks)

    def join(self):
        """Join the process group as this rank (the ``torchrun``
        environment, set for the call only), and its gloo group of the
        host for the signals."""
        saved = dict(os.environ)
        index = self.device.index
        os.environ.update(
            RANK=str(self.rank), WORLD_SIZE=str(self.world),
            LOCAL_RANK=str(self.rank if index is None else index),
            MASTER_ADDR="localhost", MASTER_PORT=str(self.port))
        try:
            mesh.init_from_env(device=self.device, timeout=TIMEOUT_S)
        finally:
            os.environ.clear()
            os.environ.update(saved)
        self.host = dist.new_group(
            backend="gloo", timeout=datetime.timedelta(seconds=TIMEOUT_S))

    def unit_inputs(self, i):
        """This rank's images of the global batch's iteration ``i``."""
        z, (first, second), psi, lr_t, lr_ll = self.inputs(i)
        a, b, k = self.rank * self.share, (self.rank + 1) * self.share, \
            self.heads
        return (z[a:b], ([x[a:b] for x in first],
                         [x[a * k:b * k] for x in second]),
                psi, lr_t, lr_ll)

    def signal(self, code=None):
        """Rank 0 sends ``code`` to the other ranks; they receive it. A
        send returns once the one before it has been taken, so rank 0 runs
        at most one block ahead of the others' hosts."""
        if code is None:
            t = torch.tensor([0])
            dist.broadcast(t, 0, group=self.host)
            return int(t)
        if self.sent:
            self.sent[0].wait()
        t = torch.tensor([code])
        self.sent = (dist.broadcast(t, 0, group=self.host, async_op=True), t)
        return code

    def agree(self, complete):
        """Whether every rank's traced window is complete."""
        t = torch.tensor([int(complete)])
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.host)
        return bool(t)

    def run_unit(self):
        if self.following:  # a unit of the window or of a traced series
            if self.rank == 0 and not self.series:
                if not self.left:
                    self.left = self.signal(self.log_every)
                self.left -= 1
            self.units += 1
        return super().run_unit()

    def profiled(self, work):
        """``trace.profiled`` of ``work`` on every rank: rank 0 runs the
        series' units, the others as many on its signal."""
        self.signal(TRACE)
        self.series = True
        try:
            return trace.profiled(work, agree=self.agree)
        finally:
            self.series = False

    def follow(self):
        """A rank other than 0: the units rank 0 signals, until ``END``.
        Returns its traced window's busy seconds, or None."""
        busy = None
        n = self.traffic["trace_units"]
        while (code := self.signal()) != END:
            if code == TRACE:
                events, span, _ = trace.profiled(
                    lambda: [self.run_unit() for _ in range(n)],
                    agree=self.agree)
                busy = trace.Trace(events, span, n, {}).busy_s
            else:
                for _ in range(code):
                    self.run_unit()
        return busy

    def release(self, busy_s=None):
        """Once the window has closed: the checked steps again on every
        rank; the other ranks' peak memory, traced busy seconds, units
        run and forbidden modules gathered on rank 0 (``peers``); the other ranks ended and the
        process group left before rank 0 runs the reference. Rank 0 first
        finishes the block that the window closed in. Raises where a rank
        ran other units than rank 0."""
        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0)
        if self.rank == 0:
            while self.left:
                self.run_unit()
            self.signal(END)
        self.following = False
        super().release()
        mine = {"memory_peak_bytes": peak, "busy_s": busy_s,
                "units": self.units, "forbidden": run.forbidden_modules()}
        every = [None] * self.world
        dist.all_gather_object(every, mine, group=self.host)
        self.peers = every[1:]
        if self.rank == 0:
            self.end_ranks()
            units = [p["units"] for p in every]
            if len(set(units)) > 1:
                raise RuntimeError(f"the ranks ran {units} units")

    def end_ranks(self):
        """Rank 0 leaves the group with the others (NCCL's teardown waits
        for every rank), then waits for their processes to end."""
        mesh.shutdown()
        deadline = time.monotonic() + TIMEOUT_S
        try:
            failed = {}
            for r, p in enumerate(self.procs, 1):
                try:
                    code = p.wait(max(0.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    code = None
                if code != 0:
                    failed[r] = code
            if failed:
                raise RuntimeError(f"ranks ended badly: {failed}")
        finally:
            self.kill_ranks()

    def kill_ranks(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _end_with_parent(parent):
    """Ends this process once its parent, rank 0, has gone."""
    while os.getppid() == parent:
        time.sleep(1.0)
    os._exit(1)


def rank_main(rank, job):
    """A spawned rank: its state built beside rank 0's, then the units
    rank 0 signals, then the checked passes; under the job's fault where
    the run has one."""
    threading.Thread(target=_end_with_parent, args=(os.getppid(),),
                     daemon=True).start()
    if job["device"] == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(CPU_THREADS)
    broken = contextlib.nullcontext()
    if job["fault"]:
        from portbench import faults
        broken = faults.FAULTS["train_ranks"][job["fault"]]()
    try:
        with broken:
            cell = RanksCell(job["cfg"], job["traffic"], job["seed"], device,
                             {}, job["compute_dtype"], rank=rank,
                             port=job["port"])
            cell.release(cell.follow())
    finally:
        mesh.shutdown()


def build(cfg, traffic, seed, device, parts, compute_dtype="float32"):
    return RanksCell(cfg, traffic, seed, device, parts, compute_dtype)


if __name__ == "__main__":
    from portbench.drivers.train_ranks import rank_main
    rank_main(int(sys.argv[1]), json.loads(sys.argv[2]))
