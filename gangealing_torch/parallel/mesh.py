"""Ranks, cards and the cross-rank helpers: the multi-process runtime of
the port.

Port of gangealing_tpu/parallel/mesh.py to ``torch.distributed``, one rank
per card in the style of ``torchrun``. A JAX process with its local mesh
is one rank with one card here:

  * rank, world and card come from the ``torchrun`` environment: ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK`` (the card ``cuda:LOCAL_RANK``, which
    ``init_from_env`` returns), ``MASTER_ADDR`` and ``MASTER_PORT``.
    Without that environment the world is 1 and nothing is initialised;
  * the backend is ``nccl`` for a card and ``gloo`` for the CPU, unless the
    caller names another; nothing falls back from one to the other;
  * the host-side numpy gathers and the barriers go through a gloo group,
    also when the default group is NCCL.

The JAX mesh helpers (``make_mesh``, ``data_sharding``,
``replicated_sharding``, ``shard_batch``, ``replicate``, ``auto_mesh``,
``mesh_size``) have no counterpart: one rank drives one card, so there is
no local mesh to lay a batch out on. The cross-process helpers keep their
names: ``process_stripe``, ``gather_process_stripes``, ``all_gather_hosts``,
``all_gatherv_hosts``, ``host_barrier`` and ``shard_global_batch``. The
training steps add ``broadcast_modules`` and ``all_reduce_grads`` (an
explicit all-reduce in place of the replicated step's psums), and
``mean_over_ranks`` for the logged terms. Without a process group each
helper is the identity or does nothing.
"""

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from gangealing_torch.utils.profiling import span

_HOST_GROUP = {}  # the gloo group of the host-side helpers, once made


def init_from_env(backend=None, device="cuda", timeout=None):
    """Join the process group that the ``torchrun`` environment describes,
    and return this rank's device: ``device``, with a card's index set to
    ``LOCAL_RANK`` when none is given. Without ``RANK`` in the environment
    nothing is initialised (world 1). ``backend`` defaults to ``nccl`` for
    a card and ``gloo`` for the CPU; ``timeout`` (seconds) bounds every
    collective. Raises for a card when none is visible."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} was asked for but no CUDA "
                               "device is visible; pass the CPU explicitly "
                               "to run there")
        if dev.index is None and "LOCAL_RANK" in os.environ:
            dev = torch.device("cuda", local_rank())
        if dev.index is not None:
            torch.cuda.set_device(dev)
    if "RANK" not in os.environ or dist.is_initialized():
        return dev
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {} if timeout is None else dict(
        timeout=datetime.timedelta(seconds=timeout))
    dist.init_process_group(backend, init_method="env://", **kw)
    if backend != "gloo":
        # made by every rank at once, as new_group requires
        _HOST_GROUP["group"] = dist.new_group(backend="gloo", **{
            k: v for k, v in kw.items() if k == "timeout"})
    return dev


def shutdown():
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _HOST_GROUP.clear()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def is_primary() -> bool:
    """Rank 0, the one rank that writes the shared files."""
    return rank() == 0


def _host_group():
    return _HOST_GROUP.get("group")


def process_stripe(n: int):
    """This rank's stride of ``n`` items: [r, r+W, r+2W, ...], the
    reference's DistributedSampler striding; range(n) at world 1."""
    return list(range(rank(), n, world_size()))


def all_gather_hosts(x):
    """Gather a host array of the same shape and dtype from every rank:
    (W, *x.shape), in rank order. Identity at world 1."""
    if world_size() == 1:
        return x
    x = np.ascontiguousarray(x)
    W = world_size()
    if x.nbytes == 0:
        return np.zeros((W,) + x.shape, x.dtype)
    t = torch.from_numpy(x.reshape(-1).view(np.uint8).copy())
    out = [torch.empty_like(t) for _ in range(W)]
    dist.all_gather(out, t, group=_host_group())
    return np.stack([o.numpy().view(x.dtype).reshape(x.shape) for o in out])


def all_gatherv_hosts(x):
    """Concatenate the ranks' arrays of different lengths along axis 0, in
    rank order (the reference's all_gatherv: gather the lengths, pad to the
    longest, gather, trim). Identity at world 1."""
    x = np.asarray(x)
    if world_size() == 1:
        return x
    lens = np.asarray(all_gather_hosts(
        np.asarray([x.shape[0]], np.int64))).reshape(-1)
    m = int(lens.max())
    padded = np.zeros((m,) + x.shape[1:], x.dtype)
    padded[:x.shape[0]] = x
    g = np.asarray(all_gather_hosts(padded))  # (W, m, ...)
    return np.concatenate([g[p, :lens[p]] for p in range(g.shape[0])], 0)


_STRIPE_MAXD = 8  # max trailing dims carried in the stripe descriptor


def gather_process_stripes(chunks, n_total: int):
    """Inverse of process_stripe for per-item results: gather each rank's
    stripe and de-interleave back to global item order. ``chunks`` is this
    rank's results in stripe order, a list of (n_i, ...) arrays that are
    concatenated on axis 0; an empty list is an empty stripe (n_total <
    W), which takes the trailing shape and dtype of the ranks that have
    items from a descriptor gather. Short stripes are padded by repeating
    the last row, which lands past ``n_total`` and is trimmed."""
    W = world_size()
    x = np.concatenate(chunks, 0) if chunks else np.zeros((0,))
    if W == 1:
        return x[:n_total]
    if x.ndim - 1 > _STRIPE_MAXD:
        raise ValueError(f"items with >{_STRIPE_MAXD} dims not supported")
    # descriptor: [n_local, ndim, tail shape (MAXD), dtype.str as bytes]
    d = np.zeros(2 + _STRIPE_MAXD + 8, np.int64)
    d[0], d[1] = x.shape[0], x.ndim
    d[2:2 + x.ndim - 1] = x.shape[1:]
    d[2 + _STRIPE_MAXD:] = np.frombuffer(x.dtype.str.encode().ljust(8),
                                         np.uint8)
    g_d = all_gather_hosts(d)  # (W, D)
    ref = next((g_d[p] for p in range(W) if g_d[p][0] > 0), None)
    if x.shape[0] == 0 and ref is not None:
        ndim = int(ref[1])
        tail = tuple(int(v) for v in ref[2:2 + ndim - 1])
        dtype = np.dtype(bytes(ref[2 + _STRIPE_MAXD:].astype(np.uint8))
                         .decode().strip())
        x = np.zeros((0,) + tail, dtype)
    m = (n_total + W - 1) // W
    if x.shape[0] < m:
        reps = np.repeat(x[-1:] if x.shape[0] else
                         np.zeros((1,) + x.shape[1:], x.dtype),
                         m - x.shape[0], axis=0)
        x = np.concatenate([x, reps], axis=0)
    g = all_gather_hosts(x)  # (W, m, ...)
    out = g.transpose(1, 0, *range(2, g.ndim)).reshape(
        (W * m,) + g.shape[2:])
    return out[:n_total]


def host_barrier(name: str = "barrier"):
    """Block until every rank reaches this point, e.g. before the primary
    assembles files the other ranks wrote. ``name`` says which barrier
    this is in the code. No-op at world 1."""
    if world_size() > 1:
        dist.barrier(group=_host_group())


def shard_global_batch(x):
    """This rank's rows of a global tensor that every rank holds alike:
    the contiguous block [r*n/W, (r+1)*n/W) of its first axis. Raises
    unless W divides n. ``x`` itself at world 1."""
    W = world_size()
    if W == 1:
        return x
    n = x.shape[0]
    if n % W:
        raise ValueError(f"global batch ({n}) must be divisible by the "
                         f"world size ({W})")
    b = n // W
    return x[rank() * b:(rank() + 1) * b]


def broadcast_modules(*modules, src: int = 0):
    """Overwrite every parameter and buffer of ``modules`` with rank
    ``src``'s, over the default group. No-op unless initialised."""
    if not dist.is_initialized():
        return
    with torch.no_grad():
        for module in modules:
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src)


def all_reduce_grads(*modules):
    """Replace each gradient of ``modules`` by its mean over the ranks: one
    flat bucket a module, summed over the default group, then divided by
    W. Parameters without a gradient are left out (they have none on any
    rank). No-op unless initialised; at world 1 the sum and the division
    by 1 leave every bit as it was."""
    if not dist.is_initialized():
        return
    W = world_size()
    with span("train.allreduce"):
        for module in modules:
            grads = [p.grad for p in module.parameters()
                     if p.grad is not None]
            if not grads:
                continue
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat)
            flat.div_(W)
            offset = 0
            for g in grads:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()


def mean_over_ranks(x):
    """The mean over the ranks of a tensor that each rank holds: summed
    over the default group, then divided by W. ``x`` itself unless
    initialised."""
    if not dist.is_initialized():
        return x
    x = x.detach().clone()
    dist.all_reduce(x)
    return x.div_(world_size())
