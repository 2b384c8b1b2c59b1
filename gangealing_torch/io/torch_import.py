"""Reading reference-schema ``.pt`` checkpoints.

The port's own copy of the checkpoint reader of
gangealing_tpu/io/torch_import.py (``_should_drop``, ``import_state_dict``,
``load_torch_checkpoint``, ``learnable_key_order``). The published
GANgealing model zoo (reference utils/download.py:10-29) ships torch ``.pt``
dicts with keys ``g_ema, t, t_ema, t_optim, t_sched, ll, ll_optim,
ll_sched, args`` (reference train.py:22-28), plus ``classifier`` for
clustering models. Buffers that are derived constants (blur kernels,
one-hot rows, identity flows) are rebuilt by the port's ops and dropped on
import: the set the reference itself filters
(spatial_transformer.py:378-385,722-726, cluster_classifier.py:98-101).
"""

from typing import Any, Dict, Mapping

import numpy as np
import torch

# Substrings identifying the non-learned buffers the port rebuilds:
_DROP_SUBSTRINGS = (
    "warp_head.one_hot",
    "warp_head.rebias",
    "input_downsample.kernel_horz",
    "input_downsample.kernel_vert",
    "warper.blur_filter",
    ".blur.kernel",          # Blur module FIR buffers (networks.py:79)
    ".upsample.kernel",      # ToRGB upsample buffer
    "skip.0.kernel",         # ResBlock skip Blur buffer
    "conv2.0.kernel",        # ResBlock conv2 Blur buffer
)

# Keys of the flat parameter dicts that are torch buffers, which hold no
# optimizer state:
_BUFFER_PREFIXES = ("noises.",)
_BUFFER_KEYS = {"directions", "lat_mean", "input.input_buffer"}


def _should_drop(key: str) -> bool:
    return any(s in key for s in _DROP_SUBSTRINGS)


def import_state_dict(state_dict: Mapping[str, Any],
                      dtype=np.float32) -> Dict[str, np.ndarray]:
    """torch state_dict -> flat numpy dict (same keys, buffers dropped).
    Every array is a copy, so later in-place updates of the tensors do not
    reach it."""
    out = {}
    for k, v in state_dict.items():
        if _should_drop(k):
            continue
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        out[k] = np.array(v, dtype=dtype, copy=True)
    return out


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """Load a GANgealing ``.pt`` checkpoint into numpy-backed dicts.

    Returns a dict with any of: 'g_ema', 't', 't_ema', 'll', 'classifier'
    (flat numpy param dicts) and 'args' (plain dict of hyperparameters),
    and the whole loaded checkpoint under '_raw'.
    """
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    out: Dict[str, Any] = {"_raw": ckpt}
    for name in ("g_ema", "t", "t_ema", "ll", "classifier"):
        if name in ckpt:
            out[name] = import_state_dict(ckpt[name])
    if "args" in ckpt:
        args = ckpt["args"]
        out["args"] = (dict(vars(args)) if hasattr(args, "__dict__")
                       else dict(args))
    return out


def learnable_key_order(params):
    """The order of the reference module's ``parameters()`` for a flat
    parameter dict or state_dict: its keys in insertion order, buffers
    (fixed noise images, PCA directions and mean) left out. It is the index
    order of the reference's ``optimizer.state_dict()``."""
    out = []
    for k in params:
        if k in _BUFFER_KEYS or any(k.startswith(p)
                                    for p in _BUFFER_PREFIXES):
            continue
        out.append(k)
    return out
