"""Checkpoint loading for the serving apps (port of the STN part of
gangealing_tpu/apps/common.py::load_stn)."""

from typing import Any, Mapping

from gangealing_torch.io.from_jax import params_from_jax
from gangealing_torch.models.stn import ComposedSTN, ComposedSTNConfig


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


def load_stn(ckpt_path, supersize=256, override=False, device="cpu"):
    """Load a reference-schema checkpoint's ``t_ema`` into a ComposedSTN.

    ``ckpt_path`` is a ``.pt`` path or a model-zoo name (e.g. 'cat'); for a
    zoo name the published test-time hyperparameters are merged into the
    stored args unless ``override`` (applications/__init__.py:36-39).
    Returns ``(model, cfg)``, the model in eval mode on ``device``.

    The checkpoint reader and the model zoo are the JAX package's numpy- and
    torch-only modules, imported here so that importing the port never runs
    a ``gangealing_tpu`` package ``__init__``.
    """
    from gangealing_tpu.io.torch_import import load_torch_checkpoint
    from gangealing_tpu.utils.download import (
        PRETRAINED_TEST_HYPERPARAMS, find_model)

    resolved, is_zoo = find_model(ckpt_path)
    ckpt = load_torch_checkpoint(resolved)
    args = ckpt.get("args", {})
    if is_zoo and not override and ckpt_path in PRETRAINED_TEST_HYPERPARAMS:
        args = {**args, **PRETRAINED_TEST_HYPERPARAMS[ckpt_path]}
    cfg = stn_config_from_args(args, supersize=supersize)
    model = ComposedSTN(cfg, device=device)
    model.load_state_dict(params_from_jax(ckpt["t_ema"]), strict=True)
    return model.eval(), cfg
