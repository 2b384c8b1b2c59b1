"""Carry weights from the JAX package into the port.

The JAX package keeps its parameters in flat dicts keyed by the reference's
torch state_dict names, so the carry-over is a copy per tensor.
"""

import numpy as np
import torch


def params_from_jax(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Flat ``{name: array}`` dict (JAX or numpy arrays) -> a state_dict of
    float32 CPU tensors that owns its memory."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, copy=True))
            for k, v in flat.items()}
