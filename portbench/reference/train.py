"""The plain GANgealing train step, at the precision the configurations
state: float32, cuDNN convolutions in TF32, matrix products in full float32.

It follows gangealing_torch/train/state.py::train_step over the frozen
copies beside it: two generator passes, the STN forward and backward
through the plain mipmap warp, the perceptual, TV and flow-identity terms,
an Adam step for the STN and one for the latent learner, and the EMA of the
STN. It records what the benchmark compares: each step's loss terms, the
gradients of the first step, and the parameters after each step.
"""

import contextlib
import copy

import torch

from portbench.reference.flow import flow_identity_loss, total_variation_loss
from portbench.reference.latent_learner import (
    LatentLearner, LatentLearnerConfig)
from portbench.reference.losses import gangealing_cluster_loss, gangealing_loss
from portbench.reference.lpips import LPIPS, make_perceptual_loss
from portbench.reference.stn import ComposedSTN, ComposedSTNConfig
from portbench.reference.stylegan2 import Generator, GeneratorConfig

EMA_ACCUM = 0.5 ** (32 / (10 * 1000))  # train.py:77


@contextlib.contextmanager
def tf32_flags(matmul, cudnn):
    """cuBLAS's and cuDNN's TF32 flags set while the block runs; the flags,
    which are process-wide, are put back as they were after it."""
    backends = torch.backends
    saved = (backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32)
    backends.cuda.matmul.allow_tf32 = matmul
    backends.cudnn.allow_tf32 = cudnn
    try:
        yield
    finally:
        backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32 = saved


def full_float32():
    """TF32 off for cuDNN and cuBLAS while the block runs."""
    return tf32_flags(False, False)


def stated_precision():
    """The configurations' precision, torch's defaults: cuDNN convolutions
    in TF32, matrix products in full float32."""
    return tf32_flags(False, True)


def model_configs(cfg):
    """The reference's (GeneratorConfig, ComposedSTNConfig,
    LatentLearnerConfig) of a configuration file's dict."""
    g, t, ll = cfg["generator"], cfg["stn"], cfg["latent_learner"]
    g_cfg = GeneratorConfig(size=g["size"], style_dim=g["style_dim"],
                            n_mlp=g["n_mlp"],
                            channel_multiplier=g["channel_multiplier"],
                            max_channels=g.get("max_channels", 512))
    t_cfg = ComposedSTNConfig(
        transforms=tuple(t["transforms"]), flow_size=t["flow_size"],
        supersize=t["supersize"], channel_multiplier=t["channel_multiplier"],
        num_heads=t["num_heads"], flow_downsample=t["flow_downsample"],
        antialias=t["antialias"], max_channels=t.get("max_channels", 512))
    ll_cfg = LatentLearnerConfig(n_comps=ll["ndirs"], inject_index=ll["inject"],
                                 n_latent=g_cfg.n_latent,
                                 num_heads=t["num_heads"],
                                 style_dim=g["style_dim"])
    return g_cfg, t_cfg, ll_cfg


def build_modules(cfg, device):
    """The reference's generator, STN, latent learner and perceptual model
    of a configuration, with their default weights, on ``device`` ("meta"
    to read names and shapes only)."""
    g_cfg, t_cfg, ll_cfg = model_configs(cfg)
    use_lins = cfg["train"]["loss_fn"] == "lpips"
    return {"g": Generator(g_cfg, device=device),
            "t": ComposedSTN(t_cfg, device=device),
            "ll": LatentLearner(ll_cfg, device=device),
            "lpips": LPIPS(use_lins=use_lins, device=device)}


class ReferenceTrainer:
    """The modules of a configuration loaded from ``states`` (a state_dict
    each for "g", "t", "ll" and "lpips"), their two Adams and the EMA.
    ``chunk``: the images a forward and backward takes at a time, so that
    a large batch fits beside the card's other work; None takes the whole
    batch at once."""

    def __init__(self, cfg, states, device, chunk=None):
        self.cfg = cfg
        self.train = cfg["train"]
        self.chunk = chunk
        mods = build_modules(cfg, device)
        for name, module in mods.items():
            module.load_state_dict(states[name], strict=True)
        self.g = mods["g"].eval().requires_grad_(False)
        self.lpips = mods["lpips"].eval().requires_grad_(False)
        self.t = mods["t"].train()
        self.ll = mods["ll"].train()
        self.t_ema = copy.deepcopy(self.t).eval().requires_grad_(False)
        loss = make_perceptual_loss(self.train["loss_fn"])
        self.perceptual = lambda x, y: loss(self.lpips, x, y)
        adam = dict(betas=(0.9, 0.999), eps=1e-8, foreach=False)
        self.t_optim = torch.optim.Adam(self.t.parameters(),
                                        lr=self.train["stn_lr"], **adam)
        self.ll_optim = torch.optim.Adam(self.ll.parameters(),
                                         lr=self.train["ll_lr"], **adam)

    def learned(self):
        """{name: tensor} of the STN's and the latent learner's parameters
        and of the EMA, under the names ``portbench.drivers.train`` reads
        from the port."""
        out = {f"t.{k}": v for k, v in self.t.named_parameters()}
        out.update({f"ll.{k}": v for k, v in self.ll.named_parameters()})
        out.update({f"t_ema.{k}": v
                    for k, v in self.t_ema.named_parameters()})
        return out

    def step(self, z, noise, psi, lr_t, lr_ll, around_first=None):
        """One iteration. Returns (the loss terms [p, tv, f] as floats,
        the gradients {name: tensor} of the STN and the latent learner).

        The batch runs in chunks of ``self.chunk`` images: each chunk's
        batch-mean terms are weighted by its share of the batch, the
        gradients of the chunks are summed, and then one Adam step is
        taken. ``around_first``: a context manager entered around the first
        chunk's forward and backward (the counters of one card's share)."""
        tr = self.train
        for optim, lr in ((self.t_optim, lr_t), (self.ll_optim, lr_ll)):
            for group in optim.param_groups:
                group["lr"] = float(lr)
        self.t_optim.zero_grad(set_to_none=True)
        self.ll_optim.zero_grad(set_to_none=True)
        n = z.shape[0]
        chunk = self.chunk or n
        heads = self.t.cfg.num_heads
        terms = torch.zeros(3, device=z.device)
        for a in range(0, n, chunk):
            b = min(a + chunk, n)
            first, second = noise
            part = ([x[a:b] for x in first],
                    [x[a * heads:b * heads] for x in second])
            with (around_first() if around_first and a == 0
                  else contextlib.nullcontext()):
                chunk_terms = self._losses(z[a:b], part, psi)
                total = (chunk_terms[0] + tr["tv_weight"] * chunk_terms[1]
                         + tr["flow_identity_weight"] * chunk_terms[2])
                share = (b - a) / n
                (share * total).backward()
            terms += share * torch.stack(chunk_terms).detach()
        grads = {f"t.{k}": p.grad.detach().clone()
                 for k, p in self.t.named_parameters()}
        grads.update({f"ll.{k}": p.grad.detach().clone()
                      for k, p in self.ll.named_parameters()})
        self.t_optim.step()
        self.ll_optim.step()
        with torch.no_grad():
            for e, p in zip(self.t_ema.parameters(), self.t.parameters()):
                e.mul_(EMA_ACCUM).add_(p, alpha=1.0 - EMA_ACCUM)
        return [float(x) for x in terms], grads

    def _losses(self, z, noise, psi):
        """(perceptual, TV, flow-identity) terms, each a batch mean, of the
        images ``z`` with their ``noise``."""
        tr = self.train
        kw = dict(sample_from_full_res=tr["sample_from_full_res"],
                  padding_mode=tr["padding_mode"], noise=noise)
        heads = self.t.cfg.num_heads
        if heads > 1 or tr["flips"]:
            ploss, delta_flow, _ = gangealing_cluster_loss(
                self.g, self.t, self.ll, self.perceptual, z, psi, heads,
                tr["flips"], **kw)
        else:
            ploss, delta_flow = gangealing_loss(
                self.g, self.t, self.ll, self.perceptual, z, psi, **kw)
        return (ploss, total_variation_loss(delta_flow),
                flow_identity_loss(delta_flow))
