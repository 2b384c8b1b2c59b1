"""The port's StyleGAN2 generator and its layers against the JAX package's,
on the CPU.

The JAX init weights go through ``params_from_jax`` into the port's modules
with ``strict=True``; z and the per-layer noise are made with numpy from a
seed and fed to both sides (JAX's keys and torch's generators give
different numbers). Small sizes: G 64px, style_dim 32, n_mlp 2,
max_channels 32. Tolerances, float32 on both sides: the mapping MLP and the
mean latent atol 1e-5; images and W+ latents atol 1e-4 (four resolutions of
convs, each summing in its own order); the upsampling FIR atol 1e-5.
"""

from importlib import import_module

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gangealing_torch.io import params_from_jax
from gangealing_torch.models import stylegan2 as tg
from gangealing_torch.ops import resample as trs

jsg = import_module("gangealing_tpu.models.stylegan2")
jrs = import_module("gangealing_tpu.ops.resample")

SMALL = dict(size=64, style_dim=32, n_mlp=2, channel_multiplier=1,
             max_channels=32)


def _close(ours, ref, atol):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=0)


def _pair(num_fp16_res=0, seed=0):
    jcfg = jsg.GeneratorConfig(**SMALL, num_fp16_res=num_fp16_res)
    params = jsg.generator_init(jax.random.PRNGKey(seed), jcfg)
    model = tg.Generator(tg.GeneratorConfig(**SMALL,
                                            num_fp16_res=num_fp16_res))
    model.load_state_dict(params_from_jax(params), strict=True)
    return jcfg, params, model


def _noise(cfg, batch, seed):
    rng = np.random.RandomState(seed)
    shapes = tg.GeneratorConfig(**SMALL).noise_shapes(batch)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("factor,pad", [(2, (2, 1)), (2, (1, 1))])
def test_upfirdn2d_upsampling(factor, pad):
    x = np.random.RandomState(0).randn(2, 3, 8, 8).astype(np.float32)
    k = jrs.make_kernel([1, 3, 3, 1]) * factor ** 2
    ref = jrs.upfirdn2d(jnp.asarray(x), k, up=factor, pad=pad)
    out = trs.upfirdn2d(torch.from_numpy(x),
                        trs.fir([1, 3, 3, 1], factor ** 2), up=factor, pad=pad)
    _close(out, ref, 1e-5)
    _close(trs.upsample2x(torch.from_numpy(x), [1, 3, 3, 1]),
           jrs.upsample2x(jnp.asarray(x), [1, 3, 3, 1]), 1e-5)


def test_state_dict_keys_equal_jax_params():
    _, params, model = _pair()
    assert set(model.state_dict()) == set(params)


def test_mapping_and_mean_latent():
    jcfg, params, model = _pair()
    key = jax.random.PRNGKey(3)
    z = np.array(jax.random.normal(key, (64, jcfg.style_dim)))
    with torch.no_grad():
        w = model.mapping(torch.from_numpy(z))
    _close(w, jsg.mapping(params, jcfg, jnp.asarray(z)), 1e-5)
    # the mean latent of the same z draw
    _close(w.mean(dim=0, keepdim=True), jsg.mean_latent(params, jcfg, key, 64),
           1e-5)
    rng = torch.Generator().manual_seed(0)
    assert model.mean_latent(16, rng).shape == (1, jcfg.style_dim)


@pytest.mark.parametrize("num_fp16_res", [0, 2])
@pytest.mark.parametrize("mode", ["plain", "mixing", "truncation", "latent"])
def test_generator_matches_jax(mode, num_fp16_res):
    """Images and W+ latents from fed z and noise: plain, style mixing at
    inject_index 3, truncation 0.7 toward a mean latent, and W input."""
    jcfg, params, model = _pair(num_fp16_res)
    rng = np.random.RandomState(1)
    z = [rng.randn(3, jcfg.style_dim).astype(np.float32) for _ in range(2)]
    noise = _noise(jcfg, 3, 2)
    kw = {}
    styles = z[:1]
    if mode == "mixing":
        styles, kw = z, dict(inject_index=3)
    elif mode == "truncation":
        tl = rng.randn(1, jcfg.style_dim).astype(np.float32)
        kw = dict(truncation=0.7, truncation_latent=tl)
    elif mode == "latent":
        kw = dict(input_is_latent=True)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    ref_img, ref_lat = jsg.generator_apply(
        params, jcfg, [jnp.asarray(s) for s in styles],
        noise=[jnp.asarray(n) for n in noise], return_latents=True, **jkw)
    with torch.no_grad():
        img, lat = model([torch.from_numpy(s) for s in styles],
                         noise=[torch.from_numpy(n) for n in noise],
                         return_latents=True, **tkw)
    assert img.shape == (3, 3, 64, 64)
    _close(img, ref_img, 1e-4)
    _close(lat, ref_lat, 1e-4)


def test_fixed_and_drawn_noise():
    """randomize_noise=False uses the noise buffers, as the JAX package
    uses its noise params; drawn noise comes from the given generator."""
    jcfg, params, model = _pair()
    z = np.random.RandomState(4).randn(2, jcfg.style_dim).astype(np.float32)
    ref, _ = jsg.generator_apply(params, jcfg, [jnp.asarray(z)],
                                 randomize_noise=False)
    with torch.no_grad():
        img, _ = model([torch.from_numpy(z)], randomize_noise=False)
        a, _ = model([torch.from_numpy(z)],
                     rng=torch.Generator().manual_seed(5))
        b, _ = model([torch.from_numpy(z)],
                     rng=torch.Generator().manual_seed(5))
    _close(img, ref, 1e-4)
    assert torch.equal(a, b)
