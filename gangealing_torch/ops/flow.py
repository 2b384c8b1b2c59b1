"""Flow-field regularizers (port of gangealing_tpu/ops/flow.py).

``total_variation_loss(flow, reduce_batch=False)`` is the per-image flow
score of the serving apps (gangealing_tpu/apps/flow_scores.py); both losses
regularise the residual flow in training.
"""

import torch


def _huber(a, reduce_dims):
    return torch.where(a <= 1.0, 0.5 * a ** 2, a - 0.5).mean(dim=reduce_dims)


def total_variation_loss(delta_flow, reduce_batch=True):
    """Smoothed-L1 total variation on an (N, H, W, 2) residual flow."""
    if delta_flow.shape[-1] != 2:
        raise ValueError(
            f"expected an (N, H, W, 2) flow, got {tuple(delta_flow.shape)}")
    reduce_dims = (0, 1, 2, 3) if reduce_batch else (1, 2, 3)
    diff_y = _huber((delta_flow[:, :-1] - delta_flow[:, 1:]).abs(), reduce_dims)
    diff_x = _huber((delta_flow[:, :, :-1] - delta_flow[:, :, 1:]).abs(),
                    reduce_dims)
    return diff_x + diff_y


def flow_identity_loss(delta_flow):
    """L2 pull toward the identity (zero residual flow)."""
    return (delta_flow ** 2).mean()
