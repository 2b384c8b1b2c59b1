"""Flow-smoothness scores for dataset filtering.

Port of gangealing_tpu/apps/flow_scores.py (reference
applications/flow_scores.py:17-70), on one device or over ranks. Per-image
score = negative TV smoothness of the predicted residual flow; low scores
mark images the STN cannot align well. Scores are cached to
<data>/flow_scores.pt in the torch format the JAX package writes, so each
package reads the other's cache.
"""

import os

import numpy as np
import torch

from gangealing_torch.apps.common import determine_flips, resolve_device
from gangealing_torch.data.dataset import (
    DataLoader, MultiResolutionDataset, Subset)
from gangealing_torch.ops.flow import total_variation_loss
from gangealing_torch.parallel.mesh import (
    all_gather_hosts, is_primary, rank, world_size)


def compute_flow_scores(model, data_path, real_size=256, batch=50, iters=1,
                        padding_mode="border", no_flip_inference=False,
                        save=True, device="cuda"):
    """Returns the (N,) numpy scores of every image of the LMDB at
    ``data_path``; with ``save``, also caches them to flow_scores.pt.

    ``model`` runs on ``device``, the card unless the caller asks for the
    CPU (it is moved there). The tail batch runs at its own size.

    Over ranks each rank scores its stride of the dataset (the loader's
    shards, wrapped to equal length), the scores are gathered and
    de-interleaved, the reference's all_gather(...).permute(1, 0)
    reduction (flow_scores.py:39-42), and only rank 0 writes the cache.
    Every rank returns all the scores."""
    device = resolve_device(device)
    model = model.to(device)
    dset = MultiResolutionDataset(data_path, resolution=real_size)
    loader = DataLoader(dset, batch_size=batch, shuffle=False,
                        drop_last=False, num_shards=world_size(),
                        shard_index=rank())
    kw = dict(iters=iters, padding_mode=padding_mode)
    scores = []
    with torch.inference_mode():
        for b in loader:
            # flip inference (a forward at 2N), then the chosen orientations
            imgs, _, _, _ = determine_flips(
                model, torch.from_numpy(b).to(device),
                no_flip_inference=no_flip_inference, **kw)
            _, _, flows, _, _ = model(imgs, **kw)
            scores.append(-total_variation_loss(
                flows, reduce_batch=False).cpu().numpy())
    scores = np.concatenate(scores)
    if world_size() > 1:
        scores = all_gather_hosts(scores).transpose(1, 0).reshape(-1)
    scores = scores[:len(dset)]
    if save and is_primary():
        torch.save(torch.from_numpy(np.ascontiguousarray(scores)),
                   os.path.join(data_path, "flow_scores.pt"))
    return scores


def get_flow_scores(model, data_path, **kwargs):
    """Cached wrapper (applications/flow_scores.py:17-22)."""
    cache = os.path.join(data_path, "flow_scores.pt")
    if os.path.exists(cache):
        return np.asarray(torch.load(cache, weights_only=False))
    return compute_flow_scores(model, data_path, **kwargs)


def get_high_score_indices(scores, fraction_retained):
    q = 1.0 - fraction_retained
    min_score = np.quantile(scores, q)
    return np.where(scores > min_score)[0].tolist()


def filter_dataset(dataset, scores, fraction_retained):
    """Drop the lowest-scoring images (applications/flow_scores.py:57-70).
    ``scores``: an array, or the path of a flow_scores.pt."""
    if isinstance(scores, str):
        scores = np.asarray(torch.load(scores, weights_only=False))
    return Subset(dataset, get_high_score_indices(scores, fraction_retained))
