"""The GANgealing training driver on one card.

Port of gangealing_tpu/train/loop.py (reference train.py:31-266) without the
mesh, the k-step scan, visuals and the profiler: per iteration the psi and
the learning rates from train/annealing.py, z and the
generator's noise from a generator seeded by the iteration, one train step,
scalars into ``scalars.jsonl``, checkpoints every ``ckpt_every`` iterations
and at every zero of the learning rate. The cold start fits the latent
learner's PCA on a pool of W latents kept on the device.
"""

import json
import os
import time

import torch

from gangealing_torch.models.latent_learner import fit_pca
from gangealing_torch.train.checkpoint import save_checkpoint
from gangealing_torch.train.state import TrainState, train_step
from gangealing_torch.train.annealing import (
    lr_cycle_iters, lr_used_at_iter, psi_at_iter)

PCA_CHUNK = 10000  # W latents made per generator call of the cold start


class ScalarWriter:
    """The scalar half of the JAX package's GANgealingWriter
    (train/visuals.py:26-47): one JSON line per value."""

    def __init__(self, results_path):
        os.makedirs(os.path.join(results_path, "checkpoints"), exist_ok=True)
        self._file = open(os.path.join(results_path, "scalars.jsonl"), "a")

    def add_scalar(self, name, value, step):
        self._file.write(json.dumps(
            {"name": name, "value": float(value), "step": int(step)}) + "\n")
        self._file.flush()

    def close(self):
        self._file.close()


def iteration_rng(seed, i, device):
    """The generator of iteration ``i``: z and the generator's noise of an
    iteration depend on the seed and ``i`` only, so a resumed run draws
    what an uninterrupted one would."""
    return torch.Generator(device).manual_seed((seed << 32) + i)


@torch.no_grad()
def cold_start_ll(ll, generator, rng, debug=False):
    """Fit the latent learner's directions and mean by PCA of a pool of W
    latents, 1M of them (1000 with ``debug``), made and kept on the
    generator's device (train.py:228-243)."""
    n_pca = 1000 if debug else 1000000
    ws = torch.cat([generator.batch_latent(min(PCA_CHUNK, n_pca - i), rng)
                    for i in range(0, n_pca, PCA_CHUNK)])
    ll.assign_pca(*fit_pca(ws, ll.cfg.n_comps))


def _log(writer, i, metrics, psi, lr_t, lr_ll):
    m = {k: float(v) for k, v in metrics.items()}
    writer.add_scalar("Loss/Reconstruction", m["p"], i)
    writer.add_scalar("Loss/TotalVariation", m["tv"], i)
    writer.add_scalar("Loss/FlowIdentity", m["f"], i)
    writer.add_scalar("Progress/psi", psi, i)
    writer.add_scalar("Progress/STN_LearningRate", lr_t, i)
    writer.add_scalar("Progress/LL_LearningRate", lr_ll, i)
    return m


def train_gangealing(state: TrainState, generator, perceptual_fn,
                     results_path, start_iter=0, seed=0, log_every=25,
                     ckpt_every=50000, args=None):
    """Run iterations start_iter+1 .. cfg.iter. ``perceptual_fn(x, y)`` ->
    (N, 1, 1, 1). Returns the state."""
    cfg = state.cfg
    device = next(state.t.parameters()).device
    with open(os.path.join(results_path, "opt.txt"), "w") as f:
        json.dump({k: str(v) for k, v in cfg.__dict__.items()}, f, indent=2)
    zero_lr = set(lr_cycle_iters(cfg.anneal_psi, cfg.period, cfg.iter, cfg.tm))
    writer = ScalarWriter(results_path)
    t0 = time.time()
    try:
        for i in range(start_iter + 1, cfg.iter + 1):
            psi = psi_at_iter(i, cfg.anneal_psi, cfg.anneal_fn)
            lr_t, lr_ll = (lr_used_at_iter(i, lr, cfg.anneal_psi, cfg.period,
                                           cfg.tm, cfg.decay)
                           for lr in (cfg.stn_lr, cfg.ll_lr))
            rng = iteration_rng(seed, i, device)
            z = torch.randn(cfg.batch, cfg.g.style_dim, generator=rng,
                            device=device)
            metrics = train_step(state, generator, perceptual_fn, z, psi,
                                 lr_t, lr_ll, rng=rng)
            if i % log_every == 0 or i in zero_lr:
                m = _log(writer, i, metrics, psi, lr_t, lr_ll)
                rate = (i - start_iter) * cfg.batch / max(time.time() - t0,
                                                          1e-9)
                print(f"\r[{i}/{cfg.iter}] p={m['p']:.4f} tv={m['tv']:.6f} "
                      f"psi={psi:.4f} {rate:.1f} imgs/s", end="", flush=True)
            if ckpt_every > 0 and (i % ckpt_every == 0 or i in zero_lr):
                save_checkpoint(os.path.join(results_path, "checkpoints",
                                             f"{str(i).zfill(7)}.pt"),
                                state, generator, i, args=args)
        print()
    finally:
        writer.close()
    return state
