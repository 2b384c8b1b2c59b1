"""GANgealing training losses: GAN-supervised pair sampling and the
unimodal perceptual reconstruction loss.

Port of gangealing_tpu/train/losses.py (reference models/losses/loss.py:
21-92): the pair sampling, the unimodal loss and the clustered one. Fresh
noise for each generator pass is drawn from ``rng`` (loss.py:66-68),
unless ``noise`` gives both passes' noise (the second pass runs at N*K
images when the latent learner has K heads). ``compute_dtype`` (a
torch dtype, or None for the parameters') is the dtype of both generator
passes' synthesis; their images come back float32.
"""

import torch

from gangealing_torch.ops.resample import bilinear_downsample
from gangealing_torch.utils.profiling import span


def resize_fake2stn(x, gen_size, flow_size):
    if gen_size > flow_size:
        return bilinear_downsample(x, gen_size // flow_size)
    return x


def sample_gan_supervised_pairs(generator, ll, z, psi, flow_size,
                                freeze_ll=False, noise=None, rng=None,
                                compute_dtype=None):
    """(unaligned, aligned target) from the frozen generator
    (loss.py:21-29). The target is resized to ``flow_size``; gradients
    reach ``ll`` through the second generator pass unless ``freeze_ll``.
    ``noise``: None, or a pair of per-layer noise lists, one per pass."""
    n_unaligned, n_aligned = noise if noise is not None else (None, None)
    with span("train.generator"), torch.no_grad():
        unaligned, w = generator([z], noise=n_unaligned, rng=rng,
                                 return_latents=True, compute_dtype=compute_dtype)
    with span("train.generator"):
        with torch.set_grad_enabled(torch.is_grad_enabled() and not freeze_ll):
            w_aligned = ll(w[:, 0, :], psi)
            aligned, _ = generator([w_aligned], input_is_latent=True,
                                   noise=n_aligned, rng=rng,
                                   compute_dtype=compute_dtype)
        target = resize_fake2stn(aligned, generator.cfg.size, flow_size)
    return unaligned, target


def _pairs(generator, stn, ll, z, psi, freeze_ll, noise, rng, pair_sampler,
           compute_dtype):
    if pair_sampler is None:
        return sample_gan_supervised_pairs(
            generator, ll, z, psi, stn.cfg.flow_size, freeze_ll=freeze_ll,
            noise=noise, rng=rng, compute_dtype=compute_dtype)
    return pair_sampler(ll, z, psi)


def gangealing_loss(generator, stn, ll, perceptual_fn, z, psi,
                    freeze_ll=False, sample_from_full_res=False,
                    padding_mode="border", noise=None, rng=None,
                    pair_sampler=None, compute_dtype=None):
    """Unimodal reconstruction loss (loss.py:64-75). Returns
    (perceptual loss, delta_flow).

    ``perceptual_fn(x, y)`` -> (N, 1, 1, 1). ``pair_sampler``: an optional
    replacement for the GAN pair source, mapping (ll, z, psi) to
    (unaligned, target at flow_size); ``generator`` may then be None. The
    unaligned fakes are resized to flow_size from their own size (the
    generator's, the JAX package's ``g_cfg.size``)."""
    unaligned, target = _pairs(generator, stn, ll, z, psi, freeze_ll, noise,
                               rng, pair_sampler, compute_dtype)
    flow_size = stn.cfg.flow_size
    resized = resize_fake2stn(unaligned, unaligned.shape[-1], flow_size)
    pred, _, delta_flow, _, _ = stn(
        resized, padding_mode=padding_mode,
        input_img_for_sampling=unaligned if sample_from_full_res else None,
        output_resolution=flow_size if sample_from_full_res else None)
    with span("train.perceptual"):
        ploss = perceptual_fn(pred, target).mean()
    return ploss, delta_flow


def assign_fake_images_to_clusters(generator, stn, ll, perceptual_fn, z, psi,
                                   num_heads, flips, freeze_ll=False,
                                   sample_from_full_res=True,
                                   padding_mode="border", noise=None,
                                   rng=None, pair_sampler=None,
                                   compute_dtype=None):
    """Congeal the fakes with every head, and with ``flips`` their mirrors
    too, and take the head of least perceptual distance to its target
    (loss.py:32-61). Returns (min distances (N,), their indices (N,) into
    the 2K (flips) or K columns, aligned predictions, delta_flow,
    unaligned, resized unaligned, distances (N, 2K or K)).

    The latent learner emits K targets a sample, k fastest, the STN's
    cartesian layout; under flips the mirrors follow the fakes on the
    batch axis and the targets repeat, so the distances come out as
    (2, N, K) and column f*K + k of a row is head k on flip f."""
    unaligned, target = _pairs(generator, stn, ll, z, psi, freeze_ll, noise,
                               rng, pair_sampler, compute_dtype)
    batch = unaligned.shape[0]
    if flips:
        unaligned = torch.cat([unaligned, unaligned.flip(3)], 0)
        target = target.repeat(2, 1, 1, 1)
    flow_size = stn.cfg.flow_size
    resized = resize_fake2stn(unaligned, unaligned.shape[-1], flow_size)
    pred, _, delta_flow, _, _ = stn(
        resized, padding_mode=padding_mode,
        input_img_for_sampling=unaligned if sample_from_full_res else None,
        output_resolution=flow_size if sample_from_full_res else None)
    with span("train.perceptual"):
        ploss = perceptual_fn(pred, target)
        if flips:
            distances = ploss.reshape(2, batch, num_heads).transpose(0, 1) \
                .reshape(batch, 2 * num_heads)
        else:
            distances = ploss.reshape(batch, num_heads)
        min_idx = distances.argmin(dim=1)
        min_val = distances.gather(1, min_idx[:, None])[:, 0]
    return min_val, min_idx, pred, delta_flow, unaligned, resized, distances


def gangealing_cluster_loss(generator, stn, ll, perceptual_fn, z, psi,
                            num_heads, flips, freeze_ll=False,
                            sample_from_full_res=True, padding_mode="border",
                            noise=None, rng=None, pair_sampler=None,
                            compute_dtype=None):
    """The clustered loss (loss.py:78-92): the mean of each fake's least
    distance, and the residual flow of the head (and flip) it went to,
    which alone the flow regularisers see. Returns (loss, assigned
    delta_flow (N, H, W, 2), assignments (N,))."""
    min_val, min_idx, _, delta_flow, _, _, _ = assign_fake_images_to_clusters(
        generator, stn, ll, perceptual_fn, z, psi, num_heads, flips,
        freeze_ll=freeze_ll, sample_from_full_res=sample_from_full_res,
        padding_mode=padding_mode, noise=noise, rng=rng,
        pair_sampler=pair_sampler, compute_dtype=compute_dtype)
    batch = min_idx.shape[0]
    hw2 = delta_flow.shape[1:]
    if flips:
        df = delta_flow.reshape(2, batch, num_heads, *hw2).transpose(0, 1) \
            .reshape(batch, 2 * num_heads, *hw2)
    else:
        df = delta_flow.reshape(batch, num_heads, *hw2)
    assigned = df[torch.arange(batch, device=df.device), min_idx]
    return min_val.mean(), assigned, min_idx
