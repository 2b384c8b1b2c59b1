"""Training visuals and the scalar writer.

Port of gangealing_tpu/train/visuals.py (reference
utils/vis_tools/training_vis.py: GANgealingWriter:190, run_loader_mean:14-28,
create_training_visuals:111-147, the cluster variants:57-108,150-172, the
animation:216-253). Scalars go to ``scalars.jsonl`` (and to TensorBoard
when asked); image grids are saved as numbered PNGs in the
results directory, which ``animate_visuals`` turns into an mp4. Every
forward runs without gradients on the device of the EMA STN; the grids
are made on the host.
"""

import json
import os
from glob import glob

import numpy as np
import torch

from gangealing_torch.train.losses import (
    assign_fake_images_to_clusters, resize_fake2stn,
    sample_gan_supervised_pairs)
from gangealing_torch.utils.flow_vis import flow_to_rgb
from gangealing_torch.utils.vis import images2grid, save_video


def _numpy(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _device(module):
    return next(module.parameters()).device


class GANgealingWriter:
    """PNG-grid and scalar writer (training_vis.py:190-213): one JSON line
    a scalar in ``scalars.jsonl``."""

    def __init__(self, results_path, log_images_to_tb=False):
        self.results_path = results_path
        os.makedirs(os.path.join(results_path, "checkpoints"), exist_ok=True)
        self._scalar_file = open(os.path.join(results_path, "scalars.jsonl"),
                                 "a")
        self.tb = None
        if log_images_to_tb:
            from torch.utils.tensorboard import SummaryWriter
            self.tb = SummaryWriter(results_path)

    def add_scalar(self, name, value, step):
        self._scalar_file.write(json.dumps(
            {"name": name, "value": float(value), "step": int(step)}) + "\n")
        self._scalar_file.flush()
        if self.tb is not None:
            self.tb.add_scalar(name, float(value), step)

    def close(self):
        self._scalar_file.close()
        if self.tb is not None:
            self.tb.close()

    def _grid(self, images, name, itr, range=(-1, 1)):
        from PIL import Image
        nrow = max(1, int(images.shape[0] ** 0.5))
        arr = images2grid(images, nrow=nrow, normalize=True, range=range)
        Image.fromarray(arr).save(
            f"{self.results_path}/{name}_{str(itr).zfill(7)}.png")

    def log_image_grid(self, images, name, itr, imgs_to_show,
                       log_mean_img=True, mean_range=None, range=(-1, 1),
                       num_heads=1):
        im = _numpy(images)
        self._grid(im[:imgs_to_show], name, itr, range=range)
        if log_mean_img:
            im = im.reshape(im.shape[0] // num_heads, num_heads, *im.shape[1:])
            self._grid(im.mean(axis=0), f"mean_{name}", itr, range=mean_range)


@torch.no_grad()
def run_loader_mean(t, loader, max_eles=12000, **stn_kwargs):
    """The congealed images of a loader of real images, up to the batch
    that reaches ``max_eles``, and their mean (training_vis.py:14-28), as
    numpy."""
    dev = _device(t)
    outs = []
    total = 0
    for x in loader:
        out, _, _, _, _ = t(torch.as_tensor(x).to(dev), **stn_kwargs)
        outs.append(_numpy(out))
        total += x.shape[0]
        if total >= max_eles:
            break
    outs = np.concatenate(outs, 0)
    return outs, outs.mean(axis=0, keepdims=True)


@torch.no_grad()
def create_fake_visuals(generator, t, ll, z, psi, n_sample, itr, writer,
                        rng=None, noise=None, **stn_kwargs):
    """GAN samples, their truncated targets and the congealed samples
    (training_vis.py:111-121). ``rng`` draws the generator's noise, unless
    ``noise`` gives both passes' (as sample_gan_supervised_pairs takes
    it)."""
    sample, target = sample_gan_supervised_pairs(
        generator, ll, z, psi, generator.cfg.size, freeze_ll=True,
        noise=noise, rng=rng)
    resized = resize_fake2stn(sample, generator.cfg.size, t.cfg.flow_size)
    transformed, _, _, _, _ = t(resized, **stn_kwargs)
    writer.log_image_grid(sample, "sample", itr, n_sample)
    writer.log_image_grid(transformed, "transformed_sample", itr, n_sample,
                          num_heads=t.cfg.num_heads)
    writer.log_image_grid(target, "truncated_sample", itr, n_sample,
                          num_heads=t.cfg.num_heads)


@torch.no_grad()
def create_training_visuals(generator, t, ll, loader, sample_reals, z, psi,
                            n_mean, n_sample, itr, writer, rng=None,
                            noise=None, **stn_kwargs):
    """The unimodal run's visuals (training_vis.py:125-147): with a real
    loader, the mean congealed real image over ``n_mean`` of them, the
    congealed ``sample_reals`` and, for a flow STN, their residual flows;
    then the fakes of ``create_fake_visuals``."""
    if loader is not None:
        _, mean_real = run_loader_mean(t, loader, n_mean, **stn_kwargs)
        writer.log_image_grid(mean_real, "mean_EMA_transformed_real_sample",
                              itr, n_sample, log_mean_img=False, range=None)
        out, _, flow, _, _ = t(torch.as_tensor(sample_reals).to(_device(t)),
                               **stn_kwargs)
        writer.log_image_grid(out, "EMA_transformed_real_sample", itr,
                              n_sample, log_mean_img=False)
        if t.cfg.is_flow:
            rgb = flow_to_rgb(_numpy(flow)).astype(np.float32) / 255.0
            writer.log_image_grid(rgb.transpose(0, 3, 1, 2), "flow_real",
                                  itr, n_sample, log_mean_img=False,
                                  range=(0, 1))
    create_fake_visuals(generator, t, ll, z, psi, n_sample, itr, writer,
                        rng=rng, noise=noise, **stn_kwargs)


@torch.no_grad()
def create_training_cluster_visuals(generator, t, ll, perceptual_fn, loader,
                                    z, big_z, psi, n_mean, n_sample,
                                    num_heads, flips, vis_batch_size, itr,
                                    writer, rng=None, **stn_kwargs):
    """The clustering run's visuals (training_vis.py:57-108,150-172): with
    a real loader, the mean congealed real image of each head and each
    head's congealed reals; the fakes of ``big_z``, assigned to heads in
    chunks of ``vis_batch_size``, each head's mean and samples; then the
    fakes of ``create_fake_visuals``."""
    if loader is not None:
        local, mean_real = run_loader_mean(t, loader, n_mean, unfold=True,
                                           **stn_kwargs)
        writer.log_image_grid(mean_real.reshape(-1, *mean_real.shape[2:]),
                              "mean_EMA_transformed_real_sample", itr,
                              n_sample, log_mean_img=False, range=None)
        for k in range(num_heads):
            writer.log_image_grid(local[:, k], f"EMA_head_{k}", itr, n_sample,
                                  log_mean_img=False)
    per_head = [[] for _ in range(num_heads)]
    for i in range(0, big_z.shape[0], vis_batch_size):
        zb = big_z[i:i + vis_batch_size]
        N = zb.shape[0]
        _, min_idx, pred, _, _, _, _ = assign_fake_images_to_clusters(
            generator, t, ll, perceptual_fn, zb, psi, num_heads, flips,
            freeze_ll=True, rng=rng, **stn_kwargs)
        # pred is (flips, N, K) streams: take each fake's assigned head
        idx = min_idx % num_heads
        flip_sel = min_idx // num_heads if flips else torch.zeros_like(idx)
        pred = pred.reshape(-1, N, num_heads, *pred.shape[1:])
        chosen = _numpy(pred[flip_sel, torch.arange(N, device=pred.device),
                             idx])
        for n, k in enumerate(_numpy(idx).tolist()):
            per_head[k].append(chosen[n])
    means = [np.stack(p).mean(axis=0) if p
             else np.zeros(pred.shape[-3:], np.float32) for p in per_head]
    writer.log_image_grid(np.stack(means),
                          "mean_generated_EMA_transformed_assigned", itr,
                          n_sample, log_mean_img=False, range=None)
    for k in range(num_heads):
        if per_head[k]:
            writer.log_image_grid(np.stack(per_head[k][:n_sample]),
                                  f"generated_EMA_assigned_head_{k}", itr,
                                  n_sample, log_mean_img=False)
    create_fake_visuals(generator, t, ll, z, psi, n_sample, itr, writer,
                        rng=rng, **stn_kwargs)


def animate_visuals(results_path, pattern, out_path, fps=15):
    """Numbered PNG grids -> mp4 (training_vis.py:216-253). Returns the
    number of frames."""
    from PIL import Image
    files = sorted(glob(os.path.join(results_path, f"{pattern}_*.png")))
    frames = [np.asarray(Image.open(f).convert("RGB")) for f in files]
    if frames:
        save_video(frames, fps, out_path)
    return len(frames)
