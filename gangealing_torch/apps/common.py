"""Shared app utilities: the device, checkpoint loading and flip inference
(port of gangealing_tpu/apps/common.py; reference
applications/__init__.py:30-84)."""

from typing import Any, Mapping

import torch

from gangealing_torch.io.from_jax import params_from_jax
from gangealing_torch.io.torch_import import load_torch_checkpoint
from gangealing_torch.models.stn import (
    ComposedSTN, ComposedSTNConfig, composed_forward_with_flip)
from gangealing_torch.utils.download import (
    PRETRAINED_TEST_HYPERPARAMS, find_model)

CLUSTER_SLICE = ("clustering models (a cluster classifier, num_heads > 1) "
                 "are not ported to gangealing_torch yet; they come with "
                 "the cluster slice")


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises for a CUDA device when no card
    is visible, rather than running somewhere else."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} was asked for but no CUDA "
                           "device is visible; pass the CPU explicitly to "
                           "run there")
    return device


def stn_config_from_args(args: Mapping[str, Any], supersize=None):
    """Build a ComposedSTNConfig from a checkpoint's stored hyperparameters."""
    transforms = args.get("transform", ["similarity", "flow"])
    if isinstance(transforms, str):
        transforms = [transforms]
    return ComposedSTNConfig(
        transforms=tuple(transforms),
        flow_size=int(args.get("flow_size", 128)),
        supersize=int(supersize if supersize is not None
                      else args.get("real_size", 256)),
        channel_multiplier=float(args.get("stn_channel_multiplier", 0.5)),
        num_heads=int(args.get("num_heads", 1)),
        # not a reference flag (its FlowHead default is 8); the JAX
        # package's own exports carry it for small architectures
        flow_downsample=int(args.get("flow_downsample", 8)),
    )


def load_stn(ckpt_path, supersize=256, override=False, device="cuda"):
    """Load a reference-schema checkpoint's ``t_ema`` into a ComposedSTN.

    ``ckpt_path`` is a ``.pt`` path or a model-zoo name (e.g. 'cat'); for a
    zoo name the published test-time hyperparameters are merged into the
    stored args unless ``override`` (applications/__init__.py:36-39).
    Returns ``(model, cfg)``, the model in eval mode on ``device``, which
    is the card unless the caller asks for the CPU.
    """
    resolved, is_zoo = find_model(ckpt_path)
    device = resolve_device(device)
    ckpt = load_torch_checkpoint(resolved)
    args = ckpt.get("args", {})
    if is_zoo and not override and ckpt_path in PRETRAINED_TEST_HYPERPARAMS:
        args = {**args, **PRETRAINED_TEST_HYPERPARAMS[ckpt_path]}
    cfg = stn_config_from_args(args, supersize=supersize)
    model = ComposedSTN(cfg, device=device)
    model.load_state_dict(params_from_jax(ckpt["t_ema"]), strict=True)
    return model.eval(), cfg


def determine_flips(model, imgs, classifier=None, cluster=None,
                    no_flip_inference=False, iters=1, padding_mode="border"):
    """Decide which inputs to mirror (applications/__init__.py:57-84).
    Returns (flipped_imgs, flip_indices (N, 1, 1, 1) bool, warp_policy,
    clusters (N,) int)."""
    N = imgs.shape[0]
    if classifier is not None:
        raise NotImplementedError(CLUSTER_SLICE)
    zeros = torch.zeros((N,), dtype=torch.int32, device=imgs.device)
    if not no_flip_inference:
        _, flipped, flip = composed_forward_with_flip(
            model, imgs, return_inputs=True, return_flip_indices=True,
            iters=iters, padding_mode=padding_mode)
        return flipped, flip, "cartesian", zeros
    flip = torch.zeros((N, 1, 1, 1), dtype=torch.bool, device=imgs.device)
    return imgs, flip, "cartesian", zeros
