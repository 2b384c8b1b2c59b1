"""Training state and the GANgealing train step.

Port of gangealing_tpu/train/state.py (reference train.py:31-171): the loss,
its backward, an Adam step for the STN and one for the latent learner, and
the EMA of the STN. Learning rates are set on every step from the schedule
(``lr_used_at_iter`` of train/annealing.py).

Each Adam takes its module's parameters in ``learnable_key_order``, the
order of the reference module's ``parameters()``, so that its state_dict
is the reference checkpoint schema.
"""

import copy
from dataclasses import dataclass

import torch

from gangealing_torch.models.latent_learner import (
    LatentLearner, LatentLearnerConfig)
from gangealing_torch.models.layers import dtype_of
from gangealing_torch.models.stn import ComposedSTN, ComposedSTNConfig
from gangealing_torch.models.stylegan2 import GeneratorConfig
from gangealing_torch.ops.flow import flow_identity_loss, total_variation_loss
from gangealing_torch.train.losses import (
    gangealing_cluster_loss, gangealing_loss)
from gangealing_torch.io.torch_import import learnable_key_order

EMA_ACCUM = 0.5 ** (32 / (10 * 1000))  # train.py:77


@dataclass(frozen=True)
class TrainConfig:
    g: GeneratorConfig
    t: ComposedSTNConfig
    ll: LatentLearnerConfig
    batch: int = 40                  # the batch of the one card
    stn_lr: float = 1e-3
    ll_lr: float = 1e-2
    tv_weight: float = 1000.0
    flow_identity_weight: float = 1.0
    freeze_ll: bool = False
    flips: bool = False
    sample_from_full_res: bool = False
    padding_mode: str = "border"
    loss_fn: str = "vgg_ssl"
    anneal_psi: int = 150000
    anneal_fn: str = "cosine"
    period: float = 37500.0
    decay: float = 0.9
    tm: int = 2
    iter: int = 800000
    compute_dtype: str = "float32"


def make_adam(module, lr):
    named = dict(module.named_parameters())
    params = [named[k] for k in learnable_key_order(module.state_dict())]
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


class TrainState:
    """The learned modules, the EMA of the STN and the two optimizers."""

    def __init__(self, cfg: TrainConfig, t: ComposedSTN, ll: LatentLearner):
        self.cfg = cfg
        self.t = t.train()
        self.ll = ll.train()
        self.t_ema = copy.deepcopy(t).eval().requires_grad_(False)
        self.t_optim = make_adam(t, cfg.stn_lr)
        self.ll_optim = make_adam(ll, cfg.ll_lr)

    @torch.no_grad()
    def ema_update(self):
        """accumulate() (models/__init__.py:19):
        ema = EMA_ACCUM * ema + (1 - EMA_ACCUM) * p."""
        for e, p in zip(self.t_ema.parameters(), self.t.parameters()):
            e.mul_(EMA_ACCUM).add_(p, alpha=1.0 - EMA_ACCUM)


def set_lr(optim, lr):
    for group in optim.param_groups:
        group["lr"] = float(lr)


def train_step(state: TrainState, generator, perceptual_fn, z, psi, lr_t,
               lr_ll, noise=None, rng=None):
    """One GANgealing iteration. ``perceptual_fn(x, y)`` -> (N, 1, 1, 1);
    the generator is frozen. Returns the loss terms {"p", "tv", "f"} as
    detached device scalars (reading them synchronises) and, for a
    clustering model (``num_heads > 1`` or ``flips``, loss.py:78-92),
    "assignments": each fake's head (and flip) index, whose residual flow
    alone the TV and flow-identity terms see. Both generator passes run in
    ``cfg.compute_dtype``; the perceptual trunk runs in the dtype
    ``perceptual_fn`` was made with."""
    cfg = state.cfg
    set_lr(state.t_optim, lr_t)
    set_lr(state.ll_optim, lr_ll)
    state.t_optim.zero_grad(set_to_none=True)
    state.ll_optim.zero_grad(set_to_none=True)
    kw = dict(freeze_ll=cfg.freeze_ll,
              sample_from_full_res=cfg.sample_from_full_res,
              padding_mode=cfg.padding_mode, noise=noise, rng=rng,
              compute_dtype=dtype_of(cfg.compute_dtype))
    out = {}
    if cfg.t.num_heads > 1 or cfg.flips:
        ploss, delta_flow, out["assignments"] = gangealing_cluster_loss(
            generator, state.t, state.ll, perceptual_fn, z, psi,
            cfg.t.num_heads, cfg.flips, **kw)
    else:
        ploss, delta_flow = gangealing_loss(
            generator, state.t, state.ll, perceptual_fn, z, psi, **kw)
    zero = torch.zeros((), device=ploss.device)
    tv = total_variation_loss(delta_flow) if cfg.tv_weight > 0 else zero
    fid = flow_identity_loss(delta_flow) if cfg.flow_identity_weight > 0 \
        else zero
    total = ploss + cfg.tv_weight * tv + cfg.flow_identity_weight * fid
    total.backward()
    state.t_optim.step()
    if not cfg.freeze_ll:
        state.ll_optim.step()
    state.ema_update()
    return {"p": ploss.detach(), "tv": tv.detach(), "f": fid.detach(), **out}
