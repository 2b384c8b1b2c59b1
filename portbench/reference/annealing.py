"""Schedules: psi annealing and the decaying SGDR learning-rate schedule.

The port's own copy of gangealing_tpu/train/annealing.py (reference
utils/annealing.py:7-47 for the anneal functions and lr_cycle_iters,
:50-148 for DecayingCosineAnnealingWarmRestarts). The schedules are pure
functions of the (fractional) epoch, with the reference's explicit-epoch
stepping (train.py:129-132).
"""

import math


def cosine_anneal(i, maxval, minval, num_steps):
    return minval + 0.5 * (maxval - minval) * (
        1 + math.cos(math.pi * i / num_steps))


def linear_anneal(i, maxval, minval, num_steps):
    return maxval - i * (maxval - minval) / num_steps


def fastslow_anneal(i, maxval, minval, num_steps, a=0.3):
    assert maxval == 1.0 and minval == 0.0
    na = num_steps * a
    return (na - a * i) / (na + i)


def get_psi_annealing_fn(name):
    return {"linear": linear_anneal, "cosine": cosine_anneal,
            "fastslow": fastslow_anneal}[name]


def psi_at_iter(i, anneal_psi, anneal_fn="cosine"):
    """psi for training iteration i (train.py:91-96)."""
    if anneal_psi <= 0 or i > anneal_psi:
        return 0.0
    return float(get_psi_annealing_fn(anneal_fn)(i, 1.0, 0.0, anneal_psi))


def decaying_cosine_warm_restarts(epoch, base_lr, t_0=1, t_mult=2, decay=0.9,
                                  eta_min=0.0):
    """LR at a (fractional, >= 0) epoch under SGDR with per-cycle decay.

    Mirrors DecayingCosineAnnealingWarmRestarts.step(epoch)
    (annealing.py:101-129): cycle n has length t_0 * t_mult^n and max-lr
    base_lr * decay^n.
    """
    if epoch < 0:
        raise ValueError("epoch must be >= 0")
    if epoch >= t_0:
        if t_mult == 1:
            t_cur = epoch % t_0
            n = int(epoch // t_0)
            t_i = t_0
        else:
            n = int(math.log(epoch / t_0 * (t_mult - 1) + 1, t_mult))
            t_cur = epoch - t_0 * (t_mult ** n - 1) / (t_mult - 1)
            t_i = t_0 * t_mult ** n
    else:
        t_i = t_0
        t_cur = epoch
        n = 0
    cur_decay = decay ** n
    return cur_decay * (eta_min + (base_lr - eta_min)
                        * (1 + math.cos(math.pi * t_cur / t_i)) / 2)


def lr_at_iter(i, base_lr, anneal_psi, period, t_mult=2, decay=0.9):
    """LR for training iteration i: base_lr until psi hits zero, then the
    decaying warm-restart schedule in units of ``period`` iterations
    (train.py:129-132)."""
    if i <= anneal_psi:
        return base_lr
    epoch = max(0.0, (i - anneal_psi) / period)
    return decaying_cosine_warm_restarts(epoch, base_lr, t_0=1, t_mult=t_mult,
                                         decay=decay)


def lr_used_at_iter(i, base_lr, anneal_psi, period, t_mult=2, decay=0.9):
    """LR actually APPLIED by the optimizer update at iteration i.

    The reference steps the scheduler AFTER the optimizer update
    (train.py:125-132), so iteration i's update runs on the LR set by
    iteration i-1's sched.step — i.e. lr_at_iter(i - 1). In particular the
    first post-annealing iteration (i = anneal_psi + 1) still uses base_lr."""
    return lr_at_iter(i - 1, base_lr, anneal_psi, period, t_mult=t_mult,
                      decay=decay)


def lr_cycle_iters(anneal_psi, period, total_iter, tm):
    """Iterations at which the LR hits zero (checkpointing points,
    annealing.py:40-47). Degenerate configs (run shorter than one cycle)
    yield just the end-of-annealing point."""
    zero_lr_iters = [anneal_psi - 1]
    remaining = total_iter - anneal_psi
    if remaining < period or remaining <= 0 or tm <= 1:
        return zero_lr_iters
    num_cycles = int(math.log(remaining / period, tm))
    for n in range(num_cycles):
        step = zero_lr_iters[-1] + period * tm ** n
        zero_lr_iters.append(int(step))
    return zero_lr_iters
