"""Checkpoints in the reference ``.pt`` schema.

Port of the torch half of gangealing_tpu/train/checkpoint.py: a checkpoint
holds exactly the keys ``export_torch`` writes (``g_ema, t, t_ema, ll,
t_optim, ll_optim, t_sched, ll_sched, args``; reference train.py:22-28),
with every tensor on the CPU. The port resumes from its own checkpoints and
from the JAX package's exports, whose Adam moments are in the same torch
schema. The pure-Python helpers (scheduler state, checkpoint discovery,
start iteration) are the port's own copies of the JAX package's
(gangealing_tpu/train/checkpoint.py:59-86,125-158). A checkpoint name
resolves through utils/download.find_model alone.
"""

import argparse
import glob
import math
import os

import torch

from gangealing_torch.io.from_jax import params_from_jax
from gangealing_torch.io.torch_import import (
    import_state_dict, learnable_key_order)


def _export_sched_state(base_lr, iteration, anneal_psi, period, tm, decay):
    """State dict of the reference's DecayingCosineAnnealingWarmRestarts
    (utils/annealing.py:50-148) at a given training iteration, so that the
    port's checkpoints restore in the reference's resume path."""
    epoch = max(0.0, (iteration - anneal_psi) / period)
    t_0 = 1
    if epoch >= t_0:
        if tm == 1:
            t_cur = epoch % t_0
            n = int(epoch // t_0)
            t_i = t_0
        else:
            n = int(math.log(epoch / t_0 * (tm - 1) + 1, tm))
            t_cur = epoch - t_0 * (tm ** n - 1) / (tm - 1)
            t_i = t_0 * tm ** n
    else:
        t_i, t_cur, n = t_0, epoch, 0
    cur_decay = decay ** n
    lr = cur_decay * base_lr * (1 + math.cos(math.pi * t_cur / t_i)) / 2 \
        if iteration > anneal_psi else base_lr
    return {"T_0": t_0, "T_i": t_i, "T_mult": tm, "eta_min": 0,
            "decay": decay, "cur_decay": cur_decay, "base_lrs": [base_lr],
            "last_epoch": math.floor(epoch), "T_cur": t_cur,
            "_step_count": int(iteration), "_last_lr": [lr],
            "_get_lr_called_within_step": False}


def latest_checkpoint(results_path: str):
    """Newest iteration-numbered .pt under <results>/checkpoints, or None
    (``--auto_resume``: rerunning the same command picks up where the last
    save left off)."""
    best = None
    best_iter = -1
    for p in glob.glob(os.path.join(results_path, "checkpoints", "*.pt")):
        stem = os.path.splitext(os.path.basename(p))[0]
        try:
            i = int(stem)
        except ValueError:
            continue
        if i > best_iter:
            best, best_iter = p, i
    return best


def parse_start_iter(ckpt_path: str) -> int:
    """The start iteration from the checkpoint's file name
    (train.py:245-253)."""
    name = os.path.basename(ckpt_path)
    if name.startswith("best_"):
        name = name[5:]
    stem = os.path.splitext(name)[0]
    try:
        return int(stem)
    except ValueError:
        return 0


def _cpu(obj):
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return obj


def save_checkpoint(path, state, generator, iteration, args=None):
    """Write ``state`` (a train.state.TrainState) and the generator's
    weights at ``iteration`` in the reference schema."""
    cfg = state.cfg
    ckpt = {
        "g_ema": generator.state_dict(),
        "t": state.t.state_dict(),
        "t_ema": state.t_ema.state_dict(),
        "ll": state.ll.state_dict(),
        "t_optim": state.t_optim.state_dict(),
        "ll_optim": state.ll_optim.state_dict(),
        "t_sched": _export_sched_state(cfg.stn_lr, iteration, cfg.anneal_psi,
                                       cfg.period, cfg.tm, cfg.decay),
        "ll_sched": _export_sched_state(cfg.ll_lr, iteration, cfg.anneal_psi,
                                        cfg.period, cfg.tm, cfg.decay),
        "args": argparse.Namespace(**(vars(args) if args is not None else {})),
    }
    torch.save(_cpu(ckpt), path)


def load_checkpoint(path):
    return torch.load(path, map_location="cpu", weights_only=False)


def module_state(sd):
    """A reference state_dict without the derived buffers the port does not
    keep (blur taps and the like), as float32 tensors."""
    return params_from_jax(import_state_dict(sd))


def _adam_state_by_name(optim_sd, saved_params, module):
    """A saved Adam state_dict re-indexed from the parameter order of the
    checkpoint's own state_dict to the module's ``learnable_key_order``.
    The reference and the port save both in that order; the JAX package's
    exports save both in sorted key order (its state dicts pass through
    pytree maps), so each checkpoint is read in its own order."""
    saved = learnable_key_order(saved_params)
    names = learnable_key_order(module.state_dict())
    if sorted(saved) != sorted(names):
        raise ValueError("the checkpoint's parameters are not the model's")
    pos = {n: i for i, n in enumerate(saved)}
    old = optim_sd["state"]
    state = {j: old[pos[n]] for j, n in enumerate(names) if pos[n] in old}
    group, = optim_sd["param_groups"]
    return {"state": state,
            "param_groups": [dict(group, params=list(range(len(names))))]}


def resume(state, ckpt):
    """Load the STN, its EMA, the latent learner and both Adams of a
    reference-schema checkpoint into ``state``, in place."""
    state.t.load_state_dict(module_state(ckpt["t"]), strict=True)
    state.t_ema.load_state_dict(module_state(ckpt["t_ema"]), strict=True)
    state.ll.load_state_dict(module_state(ckpt["ll"]), strict=True)
    state.t_optim.load_state_dict(_adam_state_by_name(
        ckpt["t_optim"], ckpt["t"], state.t))
    state.ll_optim.load_state_dict(_adam_state_by_name(
        ckpt["ll_optim"], ckpt["ll"], state.ll))
