"""The port's synthetic full-system demo (gangealing_torch/train/synthetic.py)
against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and fed to both sides; the STN and
latent learner start from the same JAX init. Tolerances: the templates
equal to the bit (both are numpy); the warp grid, the rendered images, the
pair and the L2 distance within 1e-5 scaled by max(1, max|ref|) (float32 on
both sides, only the order of the sums differs), and d/dw of the images
within 1e-4 scaled (a sum over every pixel of the image). One train step
through the sampler is held to JAX's ``make_train_step(...,
pair_sampler=...)`` as tests/test_torch_train_steps.py holds three GAN
steps: Adam's moments within 1e-2 and 2e-2 of each tensor's largest JAX
value, the parameters and the EMA within 1e-3 of the step's move or what
the moments' tolerance allows each element. As there, the JAX sampler
stops the gradient at the latent learner's ``directions`` and
``lat_mean``, which are buffers in the port.

The demo's convergence (the counterparts of tests/test_full_system.py)
is marked slow, as JAX's are, and runs on the CPU here.
"""

from importlib import import_module

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gangealing_torch.io import params_from_jax
from gangealing_torch.models import latent_learner as tll
from gangealing_torch.models import stn as tstn
from gangealing_torch.train import state as tstate
from gangealing_torch.train import synthetic as tsyn

from test_torch_train_common import (  # noqa: F401
    jnp_tree, jstate, perturb, rel_err, two_torch_threads)
from test_torch_train_steps import MU_TOL, NU_TOL, _adam_moments, \
    _check_moved, _np

jsyn = import_module("gangealing_tpu.train.synthetic")
jstn = import_module("gangealing_tpu.models.stn")
jll = import_module("gangealing_tpu.models.latent_learner")
jio = import_module("gangealing_tpu.io.torch_import")

SIZE = 64
TOL, GRAD_TOL = 1e-5, 1e-4


def _close(ours, ref, tol=TOL):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(ours.detach().numpy(), ref, atol=tol * scale,
                               rtol=0)


def _latents(seed, n):
    """Latents as the demo draws them, plus a mode channel of both signs."""
    rng = np.random.RandomState(seed)
    w = rng.randn(n, tsyn.STYLE_DIM).astype(np.float32)
    w[:, tsyn.N_POSE + tsyn.N_ELASTIC] = np.linspace(-1, 1, n)
    return w


def _templates(num_heads):
    return ([tsyn.make_template(SIZE, m) for m in range(num_heads)],
            [jsyn.make_template(SIZE, m) for m in range(num_heads)])


@pytest.mark.parametrize("mode", [0, 1])
def test_make_template(mode):
    t = tsyn.make_template(SIZE, mode)
    assert t.dtype == torch.float32 and tuple(t.shape) == (3, SIZE, SIZE)
    np.testing.assert_array_equal(t.numpy(),
                                  np.asarray(jsyn.make_template(SIZE, mode)))


def test_synthetic_warp_grid():
    w = _latents(0, 4)
    ours = tsyn.synthetic_warp_grid(torch.from_numpy(w), SIZE)
    _close(ours, jsyn.synthetic_warp_grid(jnp.asarray(w), SIZE))


@pytest.mark.parametrize("num_heads", [1, 2])
def test_synthetic_generator(num_heads):
    """The rendered images and their gradient with respect to the latents
    (through the grid, K4's path on the card) for one and two templates."""
    ts, js = _templates(num_heads)
    w = _latents(1, 4)
    cot = np.random.RandomState(2).randn(4, 3, SIZE, SIZE).astype(np.float32)
    ref, vjp = jax.vjp(lambda v: jsyn.synthetic_generator(js, v, SIZE),
                       jnp.asarray(w))
    wt = torch.from_numpy(w).requires_grad_()
    ours = tsyn.synthetic_generator(ts, wt, SIZE)
    _close(ours, ref)
    ours.backward(torch.from_numpy(cot))
    _close(wt.grad, vjp(jnp.asarray(cot))[0], GRAD_TOL)


class Setup:
    """The demo's configurations at K heads on both sides from JAX's init,
    the STN perturbed by 0.05 noise so that neither warp is an identity and
    the coefficients set from a seed."""

    def __init__(self, num_heads, batch=4):
        self.t_cfg, self.ll_cfg = tsyn.synthetic_configs(SIZE, num_heads)
        self.jt_cfg = jstn.ComposedSTNConfig(**vars(self.t_cfg))
        self.jll_cfg = jll.LatentLearnerConfig(**vars(self.ll_cfg))
        self.t_params = perturb(
            jstn.composed_stn_init(jax.random.PRNGKey(1), self.jt_cfg), 5)
        ll_params = dict(jll.latent_learner_init(jax.random.PRNGKey(2),
                                                 self.jll_cfg))
        ll = tsyn.synthetic_latent_learner(self.ll_cfg)
        ll_params["directions"] = _np(ll.directions)
        ll_params["lat_mean"] = _np(ll.lat_mean)
        ll_params["coefficients"] = (_np(ll.coefficients) + 0.3 * np.random
                                     .RandomState(3).randn(num_heads, 5)
                                     .astype(np.float32))
        self.ll_params = {k: np.asarray(v) for k, v in ll_params.items()}
        self.num_heads, self.batch = num_heads, batch
        self.templates, self.jtemplates = _templates(num_heads)

    def modules(self):
        t = tstn.ComposedSTN(self.t_cfg)
        t.load_state_dict(params_from_jax(self.t_params), strict=True)
        ll = tll.LatentLearner(self.ll_cfg)
        ll.load_state_dict(params_from_jax(self.ll_params), strict=True)
        return t, ll

    def jax_sampler(self):
        base = jsyn.make_synthetic_pair_sampler(self.jtemplates,
                                                self.jll_cfg, SIZE)

        def sampler(ll_params, key, psi, batch, z):
            ll_p = dict(ll_params)
            for k in ("directions", "lat_mean"):
                ll_p[k] = jax.lax.stop_gradient(ll_p[k])
            return base(ll_p, key, psi, batch, z)
        return sampler


@pytest.mark.parametrize("num_heads", [1, 2])
def test_pair_sampler(num_heads):
    s = Setup(num_heads)
    _, ll = s.modules()
    z = _latents(4, s.batch)
    ours = tsyn.make_synthetic_pair_sampler(s.templates, s.ll_cfg, SIZE)(
        ll, torch.from_numpy(z), 0.4)
    ref = s.jax_sampler()(jnp_tree(s.ll_params), None, 0.4, s.batch,
                          jnp.asarray(z))
    assert ours[1].shape[0] == s.batch * num_heads
    for o, r in zip(ours, ref):
        _close(o, r)


def test_l2_perceptual_fn():
    rng = np.random.RandomState(5)
    x, y = (rng.randn(3, 3, 8, 8).astype(np.float32) for _ in range(2))
    ours = tsyn.l2_perceptual_fn(torch.from_numpy(x), torch.from_numpy(y))
    assert tuple(ours.shape) == (3, 1, 1, 1)
    _close(ours, jsyn.l2_perceptual_fn(None, jnp.asarray(x), jnp.asarray(y)))


@pytest.mark.parametrize("num_heads", [1, 2])
def test_sampler_train_step_matches_jax(num_heads):
    """One train_step through the sampler (the clustered loss with two
    heads) against JAX's sampler step on the same z, psi and learning
    rates: Adam's moments, the STN, its EMA and the coefficients."""
    s = Setup(num_heads)
    z, psi, lr_t, lr_ll = _latents(6, s.batch), 0.5, 1e-3, 5e-3
    jcfg = jstate.TrainConfig(g=None, t=s.jt_cfg, ll=s.jll_cfg,
                              batch=s.batch, tv_weight=100.0,
                              padding_mode="border", loss_fn="vgg_ssl")
    step = jstate.make_train_step(jcfg, None, None, jsyn.l2_perceptual_fn,
                                  donate=False, pair_sampler=s.jax_sampler())
    jst = jstate.init_train_state(jnp_tree(s.t_params), jnp_tree(s.ll_params))
    jst, jm = step(jst, jnp.asarray(z), jax.random.PRNGKey(0),
                   jnp.float32(psi), jnp.float32(lr_t), jnp.float32(lr_ll))
    grads = {part: {n: np.asarray(jst[part].mu[n]) / 0.1
                    for n in jst[part].mu} for part in ("t_opt", "ll_opt")}

    t, ll = s.modules()
    cfg = tstate.TrainConfig(g=None, t=s.t_cfg, ll=s.ll_cfg, batch=s.batch,
                             tv_weight=100.0, padding_mode="border",
                             loss_fn="vgg_ssl")
    st = tstate.TrainState(cfg, t, ll)
    sampler = tsyn.make_synthetic_pair_sampler(s.templates, s.ll_cfg, SIZE)
    m = tstate.train_step(st, None, tsyn.l2_perceptual_fn,
                          torch.from_numpy(z), psi, lr_t, lr_ll,
                          pair_sampler=sampler)
    for k in ("p", "tv", "f"):
        assert abs(float(m[k]) - float(jm[k])) <= 1e-5 * max(
            1.0, abs(float(jm[k]))), k
    names = jio.learnable_key_order(st.t.state_dict())
    moments = _adam_moments(st.t_optim, names)
    counts = [0, 0]
    for name, p in st.t.named_parameters():
        mu, nu = moments[name]
        assert rel_err(mu, jst["t_opt"].mu[name]) <= MU_TOL, name
        assert rel_err(nu, jst["t_opt"].nu[name]) <= NU_TOL, name
        g = [grads["t_opt"][name]]
        _check_moved(_np(p), jst["t"][name], g, lr_t, counts)
        ema = dict(st.t_ema.named_parameters())[name]
        _check_moved(_np(ema), jst["t_ema"][name], g, lr_t, counts)
    (mu, nu), = _adam_moments(st.ll_optim, ["coefficients"]).values()
    assert rel_err(mu, jst["ll_opt"].mu["coefficients"]) <= MU_TOL
    assert rel_err(nu, jst["ll_opt"].nu["coefficients"]) <= NU_TOL
    _check_moved(_np(st.ll.coefficients), jst["ll"]["coefficients"],
                 [grads["ll_opt"]["coefficients"]], lr_ll, counts)
    assert float(np.abs(grads["ll_opt"]["coefficients"]).max()) > 0
    print(f"elements outside 1e-3 of the move: {counts[0]} of {counts[1]}")
    assert counts[0] <= 0.01 * counts[1]


@pytest.mark.slow
@pytest.mark.parametrize("num_heads,seed,descent,collapse", [
    (1, 0, 0.75, 0.6), (2, 1, 0.85, 0.8)])
def test_synthetic_full_system_congeals(num_heads, seed, descent, collapse):
    """tests/test_full_system.py's two demos on the port, with its
    thresholds: the loss falls after psi annealing and the congealed
    variance collapses (K=2 through the clustered loss)."""
    r = tsyn.run_synthetic_congealing(iters=60, size=SIZE, batch=8,
                                      num_heads=num_heads, seed=seed,
                                      device="cpu")
    early, late = tsyn.post_anneal_descent(r.losses, max(1, int(60 * 0.3)))
    assert np.all(np.isfinite(r.losses))
    assert late < descent * early, (early, late)
    assert r.var_after < collapse * r.var_before, (r.var_before,
                                                   r.var_after)
