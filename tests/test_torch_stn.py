"""The port's STN modules against the JAX package's, on the CPU.

JAX init weights plus seeded numpy noise of scale 0.05 (so that the warp
heads are not identities) go through ``params_from_jax`` into the port's
modules with ``strict=True``. Tolerances: layers atol 1e-5; for the heads
and the composed forward, grids, matrices and flows 1e-4 and images 5e-4, as
in the JAX package's parity tests against the reference
(test_reference_parity.py): a warped image carries the last-bit differences
of the transcendental functions in its coordinates, times the image
gradient.
"""

import argparse
import dataclasses
from importlib import import_module

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gangealing_torch.apps import common as tcommon
from gangealing_torch.io import params_from_jax
from gangealing_torch.models import layers as tl
from gangealing_torch.models import stn as tstn

jl = import_module("gangealing_tpu.models.layers")
jstn = import_module("gangealing_tpu.models.stn")
jio = import_module("gangealing_tpu.io.torch_import")

ATOL = 1e-5
GRID_TOL, OUT_TOL = 1e-4, 5e-4
SMALL = dict(transforms=("similarity", "flow"), flow_size=64, supersize=128,
             channel_multiplier=0.5, max_channels=32)


def _close(ours, ref, atol=ATOL):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=0)


def _perturb(params, seed, scale=0.05):
    rng = np.random.RandomState(seed)
    return {k: np.asarray(v) + scale * rng.randn(*v.shape).astype(np.float32)
            for k, v in params.items()}


def _load(module, params):
    module.load_state_dict(params_from_jax(params), strict=True)
    return module


def _jnp(params, prefix=None):
    return {(f"{prefix}.{k}" if prefix else k): jnp.asarray(v)
            for k, v in params.items()}


@pytest.mark.parametrize("kernel_size,downsample,activate",
                         [(3, False, True), (3, True, True), (1, True, False)])
def test_conv_layer(kernel_size, downsample, activate):
    p = _perturb(jl.conv_layer_init(jax.random.PRNGKey(0), 6, 8, kernel_size,
                                    downsample=downsample, bias=activate,
                                    activate=activate), 1)
    x = np.random.RandomState(2).randn(2, 6, 16, 16).astype(np.float32)
    ref = jl.conv_layer(_jnp(p, "l"), "l", jnp.asarray(x), kernel_size,
                        downsample=downsample, bias=activate,
                        activate=activate)
    layer = _load(tl.ConvLayer(6, 8, kernel_size, downsample=downsample,
                               bias=activate, activate=activate), p)
    _close(layer(torch.from_numpy(x)), ref)


@pytest.mark.parametrize("downsample", [False, True])
def test_res_block(downsample):
    p = _perturb(jl.res_block_init(jax.random.PRNGKey(0), 6, 8,
                                   downsample=downsample), 1)
    x = np.random.RandomState(2).randn(2, 6, 16, 16).astype(np.float32)
    ref = jl.res_block(_jnp(p, "b"), "b", jnp.asarray(x), downsample=downsample)
    block = _load(tl.ResBlock(6, 8, downsample=downsample), p)
    _close(block(torch.from_numpy(x)), ref)


def _head_inputs(num_heads, with_base):
    rng = np.random.RandomState(3)
    img = rng.randn(2, 3, 32, 32).astype(np.float32)
    base = alpha = None
    if with_base:
        base = (np.eye(2, 3)[None] + 0.2 * rng.randn(2, 2, 3)).astype(np.float32)
        alpha = np.float32(0.7)
    return rng, img, base, alpha


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("num_heads,with_base", [(1, False), (2, True)])
def test_similarity_head(num_heads, with_base):
    rng, img, base, alpha = _head_inputs(num_heads, with_base)
    feats = rng.randn(2, 16).astype(np.float32)
    p = _perturb(jstn.similarity_head_init(None, 16, num_heads), 4, scale=0.3)
    cfg = jstn.STNConfig(num_heads=num_heads)
    ref = jstn.similarity_head(_jnp(p, "warp_head"), cfg, jnp.asarray(img),
                               jnp.asarray(feats), output_resolution=24,
                               alpha=_j(alpha), base_warp=_j(base))
    head = _load(tstn.SimilarityHead(16, num_heads), p)
    out = head(_t(img), _t(feats), output_resolution=24, alpha=_t(alpha),
               base_warp=_t(base))
    _close(out[0], ref[0], OUT_TOL)
    for o, r in zip(out[1:3], ref[1:3]):
        _close(o, r, GRID_TOL)


@pytest.mark.parametrize("num_heads,with_base", [(1, False), (2, True)])
def test_flow_head(num_heads, with_base):
    rng, img, base, alpha = _head_inputs(num_heads, with_base)
    if base is not None:
        base = np.repeat(base, num_heads, axis=0)
    feats = rng.randn(2, 8, 4, 4).astype(np.float32)
    p = _perturb(jstn.flow_head_init(jax.random.PRNGKey(5), 8, num_heads, 4), 6)
    cfg = jstn.STNConfig(transform="flow", num_heads=num_heads,
                         flow_downsample=4)
    # output_resolution 24 != 16 exercises the bilinear resize of the flow
    ref = jstn.flow_head(_jnp(p, "warp_head"), cfg, jnp.asarray(img),
                         jnp.asarray(feats), output_resolution=24,
                         alpha=_j(alpha), base_warp=_j(base))
    head = _load(tstn.FlowHead(8, num_heads, 4), p)
    out = head(_t(img), _t(feats), output_resolution=24, alpha=_t(alpha),
               base_warp=_t(base))
    _close(out[0], ref[0], OUT_TOL)
    for o, r in zip(out[1:3], ref[1:3]):
        _close(o, r, GRID_TOL)


def test_convex_upsample_flow():
    rng = np.random.RandomState(7)
    flow = rng.randn(2, 5, 6, 2).astype(np.float32)
    mask = rng.randn(2, 9 * 4 * 4, 5, 6).astype(np.float32)
    ref = jstn.convex_upsample_flow(jnp.asarray(flow), jnp.asarray(mask), 4)
    _close(tstn.convex_upsample_flow(_t(flow), _t(mask), 4), ref)


@pytest.fixture(scope="module")
def small_params():
    return _perturb(jstn.composed_stn_init(
        jax.random.PRNGKey(0), jstn.ComposedSTNConfig(**SMALL)), 1)


@pytest.fixture(scope="module")
def small_imgs():
    rng = np.random.RandomState(3)
    return np.tanh(rng.randn(2, 3, 128, 128)).astype(np.float32)


def _jax_forward(params, imgs, iters=1, padding_mode="border", antialias=True,
                 **kwargs):
    cfg = jstn.ComposedSTNConfig(**{**SMALL, **kwargs}, antialias=antialias)
    return jstn.composed_stn_forward(_jnp(params), cfg, jnp.asarray(imgs),
                                     iters=iters, padding_mode=padding_mode)


def _assert_forward_close(ours, ref):
    out, grid, flow, sim_out, _ = ours
    _close(grid, ref[1], GRID_TOL)
    _close(flow, ref[2], GRID_TOL)
    _close(out, ref[0], OUT_TOL)
    _close(sim_out, ref[3], OUT_TOL)


@pytest.mark.parametrize("antialias", [True, False])
@pytest.mark.parametrize("padding_mode", ["border", "reflection", "zeros"])
@pytest.mark.parametrize("iters", [1, 3])
def test_composed_stn_forward(small_params, small_imgs, iters, padding_mode,
                              antialias):
    ref = _jax_forward(small_params, small_imgs, iters, padding_mode,
                       antialias)
    model = _load(tstn.ComposedSTN(tstn.ComposedSTNConfig(
        **SMALL, antialias=antialias)), small_params)
    with torch.no_grad():
        ours = model(_t(small_imgs), iters=iters, padding_mode=padding_mode)
    _assert_forward_close(ours, ref)
    # the perturbed warp is no identity: it samples outside the image
    assert float(ours[1].abs().max()) > 1.0


@pytest.mark.parametrize("split", [1, 2])
@pytest.mark.parametrize("with_bounds", [False, True])
def test_check_oob(with_bounds, split):
    """Out-of-bounds flags, with the full output as the bound and with
    per-image (h, w) bounds, one landscape and one portrait."""
    rng = np.random.RandomState(8)
    # per image a different reach past the border, so the flags differ
    reach = np.repeat([1.5, 1.02, 0.9, 1.1], split).reshape(-1, 1, 1, 1)
    grid = (reach * rng.uniform(-1, 1, (4 * split, 12, 12, 2))).astype(np.float32)
    bounds = np.array([[96, 128], [128, 80], [128, 128], [60, 128]],
                      np.int32) if with_bounds else None
    ref = jstn.check_oob(jnp.asarray(grid), _j(bounds), (12, 12), split)
    ours = tstn.check_oob(_t(grid), _t(bounds), (12, 12), split)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert 0 < int(ours.sum()) < 4 * split


@pytest.mark.parametrize("warp_policy", ["cartesian", "logits"])
def test_composed_stn_forward_two_heads(small_imgs, warp_policy):
    """num_heads=2: the cartesian policy (every image through both heads,
    the flow stage under the one-hot per-stream policy) and an (N, 2K)
    logits policy that picks one head per image; out-of-bounds flags too."""
    kw = dict(num_heads=2)
    params = _perturb(jstn.composed_stn_init(
        jax.random.PRNGKey(1), jstn.ComposedSTNConfig(**SMALL, **kw)), 2)
    logits = np.random.RandomState(9).randn(2, 4).astype(np.float32)
    cfg = jstn.ComposedSTNConfig(**SMALL, **kw)
    ref = jstn.composed_stn_forward(
        _jnp(params), cfg, jnp.asarray(small_imgs),
        warp_policy=(warp_policy if warp_policy == "cartesian"
                     else jnp.asarray(logits)),
        return_out_of_bounds=True)
    model = _load(tstn.ComposedSTN(tstn.ComposedSTNConfig(**SMALL, **kw)),
                  params)
    with torch.no_grad():
        ours = model(_t(small_imgs), return_out_of_bounds=True,
                     warp_policy=(warp_policy if warp_policy == "cartesian"
                                  else _t(logits)))
    assert ours[0].shape[0] == (4 if warp_policy == "cartesian" else 2)
    _assert_forward_close(ours, ref)
    np.testing.assert_array_equal(ours[4].numpy(), np.asarray(ref[4]))


@pytest.mark.parametrize("num_heads", [1, 2])
def test_state_dict_names_match_jax_at_flagship(num_heads):
    """The flagship architecture's state_dict has the JAX package's flat
    keys and shapes (checked on shapes only: no weights are made)."""
    kw = dict(flow_size=128, supersize=256, channel_multiplier=0.5,
              num_heads=num_heads)
    jshapes = jax.eval_shape(
        lambda k: jstn.composed_stn_init(k, jstn.ComposedSTNConfig(**kw)),
        jax.random.PRNGKey(0))
    model = tstn.ComposedSTN(tstn.ComposedSTNConfig(**kw), device="meta")
    ours = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert ours == {k: tuple(v.shape) for k, v in jshapes.items()}


@pytest.mark.parametrize("args", [
    {"transform": ["similarity", "flow"], "flow_size": 64,
     "stn_channel_multiplier": 0.25, "num_heads": 4, "real_size": 128},
    {"transform": "flow", "flow_downsample": 4},
    {},
])
def test_stn_config_from_args(args):
    ours = dataclasses.asdict(tcommon.stn_config_from_args(args))
    ref = dataclasses.asdict(jio.stn_config_from_args(args))
    assert ours == ref


def test_load_stn_reference_schema(tmp_path, monkeypatch, small_params,
                                   small_imgs):
    """A reference-schema .pt ({"t_ema", "args"}, as
    train/checkpoint.py::export_torch writes it, with the blur buffers the
    reference keeps in its state_dict) loads strictly through load_stn and
    serves the JAX package's forward."""
    t_ema = dict(params_from_jax(small_params))
    t_ema["stns.0.convs.1.conv2.0.kernel"] = torch.ones(4, 4) / 16
    t_ema["stns.1.convs.1.skip.0.kernel"] = torch.ones(4, 4) / 16
    args = argparse.Namespace(transform=["similarity", "flow"], flow_size=64,
                              stn_channel_multiplier=0.5, num_heads=1,
                              real_size=128)
    path = tmp_path / "ckpt.pt"
    torch.save({"t_ema": t_ema, "args": args}, path)

    # stored args carry no channel cap; this small test architecture has one
    build = tcommon.stn_config_from_args
    monkeypatch.setattr(tcommon, "stn_config_from_args",
                        lambda a, supersize=None: dataclasses.replace(
                            build(a, supersize), max_channels=32))
    model, cfg = tcommon.load_stn(str(path), supersize=128,
                                  device="cpu")
    assert cfg == tstn.ComposedSTNConfig(**SMALL)
    assert not model.training
    with torch.no_grad():
        ours = model(_t(small_imgs))
    _assert_forward_close(ours, _jax_forward(small_params, small_imgs))


def test_input_img_for_sampling_forward_and_grad(small_params, small_imgs):
    """Features from the flow_size image, warps applied to the full-size
    one, output at flow_size (training's --sample_from_full_res): the
    forward at the tolerances above, and the gradient of a seeded linear
    loss of the output with respect to every parameter and to the sampled
    image, within 1e-4 of each tensor's largest JAX gradient."""
    jrs = import_module("gangealing_tpu.ops.resample")
    small = np.array(jrs.bilinear_downsample(jnp.asarray(small_imgs), 2))
    cot = np.random.RandomState(10).randn(2, 3, 64, 64).astype(np.float32)
    cfg = jstn.ComposedSTNConfig(**SMALL)

    def jloss(p, full):
        out = jstn.composed_stn_forward(p, cfg, jnp.asarray(small),
                                        input_img_for_sampling=full,
                                        output_resolution=64)
        return jnp.sum(out[0] * cot), out

    (_, ref), (jg, jgimg) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(_jnp(small_params),
                                             jnp.asarray(small_imgs))
    model = _load(tstn.ComposedSTN(tstn.ComposedSTNConfig(**SMALL)),
                  small_params)
    full = _t(small_imgs).requires_grad_()
    ours = model(_t(small), input_img_for_sampling=full, output_resolution=64)
    assert ours[0].shape == (2, 3, 64, 64)
    _assert_forward_close([o.detach() if o is not None else o
                           for o in ours], ref)
    (ours[0] * _t(cot)).sum().backward()
    for name, p in model.named_parameters():
        r = np.asarray(jg[name])
        _close(p.grad, r, 1e-4 * max(1.0, float(np.abs(r).max())))
    r = np.asarray(jgimg)
    _close(full.grad, r, 1e-4 * max(1.0, float(np.abs(r).max())))
