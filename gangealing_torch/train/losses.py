"""GANgealing training losses: GAN-supervised pair sampling and the
unimodal perceptual reconstruction loss.

Port of gangealing_tpu/train/losses.py (reference models/losses/loss.py:
21-29, 64-75). The clustered loss comes with the cluster slice. Fresh noise
for each generator pass is drawn from ``rng`` (loss.py:66-68), unless
``noise`` gives both passes' noise.
"""

import torch

from gangealing_torch.ops.resample import bilinear_downsample


def resize_fake2stn(x, gen_size, flow_size):
    if gen_size > flow_size:
        return bilinear_downsample(x, gen_size // flow_size)
    return x


def sample_gan_supervised_pairs(generator, ll, z, psi, flow_size,
                                freeze_ll=False, noise=None, rng=None):
    """(unaligned, aligned target) from the frozen generator
    (loss.py:21-29). The target is resized to ``flow_size``; gradients
    reach ``ll`` through the second generator pass unless ``freeze_ll``.
    ``noise``: None, or a pair of per-layer noise lists, one per pass."""
    n_unaligned, n_aligned = noise if noise is not None else (None, None)
    with torch.no_grad():
        unaligned, w = generator([z], noise=n_unaligned, rng=rng,
                                 return_latents=True)
    with torch.set_grad_enabled(torch.is_grad_enabled() and not freeze_ll):
        w_aligned = ll(w[:, 0, :], psi)
        aligned, _ = generator([w_aligned], input_is_latent=True,
                               noise=n_aligned, rng=rng)
    return unaligned, resize_fake2stn(aligned, generator.cfg.size, flow_size)


def gangealing_loss(generator, stn, ll, perceptual_fn, z, psi,
                    freeze_ll=False, sample_from_full_res=False,
                    padding_mode="border", noise=None, rng=None,
                    pair_sampler=None):
    """Unimodal reconstruction loss (loss.py:64-75). Returns
    (perceptual loss, delta_flow).

    ``perceptual_fn(x, y)`` -> (N, 1, 1, 1). ``pair_sampler``: an optional
    replacement for the GAN pair source, mapping (ll, z, psi) to
    (unaligned, target at flow_size)."""
    flow_size = stn.cfg.flow_size
    if pair_sampler is None:
        unaligned, target = sample_gan_supervised_pairs(
            generator, ll, z, psi, flow_size, freeze_ll=freeze_ll,
            noise=noise, rng=rng)
    else:
        unaligned, target = pair_sampler(ll, z, psi)
    gen_size = generator.cfg.size if generator is not None else flow_size
    resized = resize_fake2stn(unaligned, gen_size, flow_size)
    pred, _, delta_flow, _, _ = stn(
        resized, padding_mode=padding_mode,
        input_img_for_sampling=unaligned if sample_from_full_res else None,
        output_resolution=flow_size if sample_from_full_res else None)
    return perceptual_fn(pred, target).mean(), delta_flow
