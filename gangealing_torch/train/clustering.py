"""K-Means++ initialisation of the cluster coefficients in W-space under the
perceptual metric.

Port of gangealing_tpu/train/clustering.py (reference
models/latent_learner.py:85-123, kmeans_plusplus) on one device, in two
steps: ``kmeans_pool`` makes G's images of a pool of W latents, and
``kmeans_pick`` samples the centroids from the pool with a numpy
``RandomState``, as the reference's rank 0 does. The reference's sharding
of the pool over ranks is not here.
"""

import numpy as np
import torch


def _fakes(generator, w, mean_w, inject_index, rng):
    """G's images of W latents ``w``, their first ``inject_index`` style
    slots from ``w`` and the rest from the mean latent."""
    img, _ = generator([w, mean_w.expand_as(w)], input_is_latent=True,
                       inject_index=inject_index, rng=rng)
    return img


@torch.no_grad()
def kmeans_pool(generator, batch_w, rng=None, inject_index=6,
                batch_size=100):
    """G's images of the W latents ``batch_w`` (M, D), their first
    ``inject_index`` style slots from each latent and the rest from the
    latents' mean, noise from ``rng``. Returns (the mean (1, D), the
    images (M, C, S, S)). The images are kept in host memory, as the JAX
    package keeps them, in one buffer filled a chunk at a time: at the
    recipe's 50,000 latents of 256 px it takes 39 GB."""
    mean_w = batch_w.mean(dim=0, keepdim=True)
    fakes = None
    for start in range(0, len(batch_w), batch_size):
        img = _fakes(generator, batch_w[start:start + batch_size], mean_w,
                     inject_index, rng)
        if fakes is None:
            fakes = torch.empty((len(batch_w),) + img.shape[1:],
                                dtype=img.dtype)
        fakes[start:start + len(img)].copy_(img)
    return mean_w, fakes


@torch.no_grad()
def kmeans_pick(generator, perceptual_fn, batch_w, mean_w, fakes, num_heads,
                random_state, inject_index=6, batch_size=100, rng=None):
    """The K-Means++ picks from a pool: the first centroid uniformly, each
    next one with probability proportional to the squared perceptual
    distance of a latent's image to its nearest centroid's image, which G
    makes anew (noise from ``rng``). ``random_state``: a numpy
    ``RandomState``, the only source of the picks. Returns the centroids'
    W latents (num_heads, D)."""
    num_latent = batch_w.shape[0]
    centroid_idx = [int(random_state.randint(0, num_latent))]
    dists = []
    for _ in range(num_heads - 1):
        center = _fakes(generator, batch_w[centroid_idx[-1]][None], mean_w,
                        inject_index, rng)
        dists.append(torch.cat([
            perceptual_fn(center.expand(len(f), -1, -1, -1),
                          f.to(center.device)).reshape(-1)
            for f in fakes.split(batch_size)]).cpu().numpy())
        closest = np.stack(dists).min(axis=0)
        logits = closest ** 2
        probs = logits / logits.sum()
        centroid_idx.append(int(random_state.choice(num_latent, p=probs)))
    return batch_w[centroid_idx]


def kmeans_plusplus(generator, perceptual_fn, num_heads, num_latent, rng,
                    inject_index=6, batch_size=100):
    """(num_heads, D) W-space centroids for the latent learner's
    coefficients. ``rng``: a torch.Generator on G's device; it draws the
    pool, G's noise and the seed of the picks' RandomState."""
    with torch.no_grad():
        batch_w = generator.batch_latent(num_latent, rng)
    mean_w, fakes = kmeans_pool(generator, batch_w, rng, inject_index,
                                batch_size)
    seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=rng,
                             device=rng.device))
    return kmeans_pick(generator, perceptual_fn, batch_w, mean_w, fakes,
                       num_heads, np.random.RandomState(seed), inject_index,
                       batch_size, rng)
