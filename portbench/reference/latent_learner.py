"""The learned target mode ("ll"): coefficients over W-space PCA directions.

Port of gangealing_tpu/models/latent_learner.py. ``coefficients`` (K, ndirs)
is the one parameter; ``directions`` (ndirs, style_dim) and ``lat_mean``
(1, style_dim) are buffers assigned from a PCA of W, as in the reference
(latent_learner.py:25-83), so the ll optimizer steps only the coefficients.

``fit_pca`` replaces the JAX package's scikit-learn ``IncrementalPCA``: an
exact PCA on the device, with scikit-learn's sign rule.
"""

from dataclasses import dataclass

import torch
from torch import nn

from portbench.reference.layers import randn


@dataclass(frozen=True)
class LatentLearnerConfig:
    n_comps: int = 1          # --ndirs
    inject_index: int = 5     # --inject
    n_latent: int = 14        # generator.n_latent
    num_heads: int = 1
    style_dim: int = 512


class LatentLearner(nn.Module):
    def __init__(self, cfg: LatentLearnerConfig, *, device=None,
                 generator=None):
        super().__init__()
        self.cfg = cfg
        self.coefficients = nn.Parameter(
            torch.zeros(cfg.num_heads, cfg.n_comps, device=device))
        self.register_buffer("directions", randn(
            (cfg.n_comps, cfg.style_dim), generator, device))
        self.register_buffer("lat_mean", randn((1, cfg.style_dim), generator,
                                               device))

    def forward(self, styled_latent, psi):
        return latent_learner_interpolate(self, styled_latent, psi)

    @torch.no_grad()
    def assign_pca(self, components, mean):
        self.directions.copy_(components)
        self.lat_mean.copy_(mean)

    @torch.no_grad()
    def assign_coefficients(self, coefficients):
        self.coefficients.copy_(coefficients)


def latent_learner_interpolate(ll: LatentLearner, styled_latent, psi):
    """styled_latent: (N, style_dim) W. Returns (N*K, n_latent, style_dim) W+
    (latent_learner.py:56-70): the first ``inject_index`` slots get the
    learned target lerped toward w by psi; the rest keep w."""
    cfg = ll.cfg
    N = styled_latent.shape[0]
    target = ll.lat_mean + ll.coefficients @ ll.directions  # (K, style_dim)
    target = target.repeat(N, 1)  # (N*K, style_dim)
    w = styled_latent.repeat_interleave(cfg.num_heads, dim=0)
    mixed = target + psi * (w - target)
    return torch.cat([
        mixed[:, None, :].expand(-1, cfg.inject_index, -1),
        w[:, None, :].expand(-1, cfg.n_latent - cfg.inject_index, -1)], dim=1)


def fit_pca(w, n_components):
    """Mean (1, D) and top ``n_components`` principal directions
    (n_components, D) of the rows of ``w``, on its device.

    The covariance is summed in float64 and diagonalised with
    ``torch.linalg.eigh``. Each direction's sign follows scikit-learn's
    ``svd_flip`` rule: its largest-magnitude entry is positive.
    """
    x = w.double()
    mean = x.mean(dim=0, keepdim=True)
    xc = x - mean
    _, vecs = torch.linalg.eigh(xc.T @ xc)
    comps = vecs[:, -n_components:].flip(1).T  # (n, D), largest first
    idx = comps.abs().argmax(dim=1)
    signs = torch.sign(comps.gather(1, idx[:, None]))
    return (comps * signs).float(), mean.float()


def pca_encode(x, components, mean):
    """The PCA coefficients of the rows of ``x``: (x - mean) @ components.T,
    the JAX package's ``PCA.encode`` (IncrementalPCA.transform, no
    whitening)."""
    return (x - mean) @ components.T
