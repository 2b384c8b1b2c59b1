"""The port's bfloat16 compute path (``--compute_dtype bfloat16``) against
the JAX package's, on the CPU.

The same seeded numpy inputs and JAX init weights (through
``params_from_jax``) go to both packages, as in the float32 tests:
StyleGAN2's synthesis at 64 px, the VGG16 trunk with the vgg_ssl and lpips
heads, a composed similarity-then-flow STN at flow_size 64 with
``compute_dtype="bfloat16"``, and one unimodal and one clustered train
step as ``cli.train --compute_dtype bfloat16`` runs them (both generator
passes and the perceptual trunk in bfloat16, the STN in float32). The
JAX perceptual loss is called with every perceptual parameter cast to
``jnp.bfloat16``, so that all 13 of its trunk convs run in bfloat16 (with
float32 parameters its float32 biases promote 12 of them back to
float32); the port's VGG holds the same bfloat16-rounded values.

Both packages round at the same points (each Python scalar too, to the
tensor's dtype, as JAX does), and layer by layer their outputs are equal
to the bit. But their convolutions sum in their own orders in float32 and
round each output to bfloat16 (a relative step of 2^-8 = 3.9e-3), so now
and then a value one side rounds up the other rounds down, and the
difference travels on through the following layers. JAX runs under
``jax.jit`` where its FIR filters then take one 2-D depthwise conv, as
the port's do (op by op it splits them in two, rounding in between).
Tolerances, with the readings over seeds (z 3 to 8, images 4 to 12, z 6
to 11) on this configuration, with 2 to 4 torch threads: G's image within
3e-2 of its largest value [2.1e-3 to 1.5e-2]; the vgg_ssl and lpips
distances rtol 1e-3 [8.6e-6 to 1.2e-4]; the STN forward on smooth images:
its output image atol 0.2 [1.9e-2 to 8.8e-2], grid 1e-2 [1.5e-3 to
4.5e-3], flow 6e-3 [1.5e-3 to 2.4e-3]; a train step's loss terms rtol 1e-2
[1.1e-5 to 9.7e-4]; its gradients, each tensor within a share of its
largest JAX value and all together in relative L2 norm: unimodal 0.1 and
3e-2 [2.7e-2 to 4.1e-2; 3.5e-3 to 1.2e-2], clustered 0.25 and 8e-2
[3.3e-2 to 1.8e-1; 4.0e-3 to 5.5e-2]. These are about a third of the gap
between the port's own bfloat16 and float32 steps (L2 1.6e-2 to 1.6e-1
at this size). The flagship congeal forward's bfloat16 grids and flows
against its float32 ones within 0.1 [1.2e-2 to 3.6e-2; 7.1e-3 to
2.0e-2], the gate chip_smoke.py holds the card to at batch 128. The
convolutions counted by input dtype equal JAX's jaxpr's: G all bfloat16
but the skip's float32 upsampling FIRs after the second ToRGB on; the
STN's encoder convs bfloat16 and its warps' and flow head's float32; the
VGG trunk's 13 convs a distance bfloat16.
"""

import collections
import dataclasses
from importlib import import_module

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import jax
import jax.numpy as jnp

from gangealing_torch.io import params_from_jax
from gangealing_torch.models import lpips as tlp
from gangealing_torch.models import stn as tstn
from gangealing_torch.models import stylegan2 as tg
from gangealing_torch.train import state as tstate

from test_torch_train_common import (  # noqa: F401
    G, T, Setup, jlosses, jlp, jsg, jstate, jstn, jnp_tree, perturb, rel_err,
    two_torch_threads)
from test_torch_cluster_train import ClusterSetup

PSI = 0.7
BF16 = jnp.bfloat16
# two distances closer than this, relative, may be ordered apart by two
# bfloat16 implementations (over z seeds 6 to 13 the port's distances
# read 3.3e-3 to 7.5e-3 from JAX's)
BF16_TIE_GAP = 2e-2


def _bf16_values(params):
    """``params`` rounded to bfloat16, as JAX arrays of that dtype."""
    return {k: jnp.asarray(v, BF16) for k, v in params.items()}


# ---------------------------------------------------------------------------
# convolutions by dtype
# ---------------------------------------------------------------------------

class _ConvDtypes(torch.overrides.TorchFunctionMode):
    """Counts the port's convolutions by the dtype of their input."""

    def __init__(self):
        super().__init__()
        self.count = collections.Counter()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (F.conv2d, F.conv_transpose2d):
            self.count[str(args[0].dtype).replace("torch.", "")] += 1
        return func(*args, **(kwargs or {}))


def _jax_conv_dtypes(fn, *args):
    """JAX's convolutions in the jaxpr of ``fn`` by the dtype of their
    input, nested jaxprs included."""
    count = collections.Counter()

    def walk(jaxpr):
        for e in jaxpr.eqns:
            if e.primitive.name == "conv_general_dilated":
                count[str(e.invars[0].aval.dtype)] += 1
            for p in e.params.values():
                for sub in p if isinstance(p, (list, tuple)) else [p]:
                    inner = getattr(sub, "jaxpr", sub)
                    if hasattr(inner, "eqns"):
                        walk(inner)
    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return count


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------

def _generator_pair():
    """G at 64 px with its noise weights and ToRGB biases moved off zero,
    so that the noise and both bias casts take part."""
    jcfg = jsg.GeneratorConfig(**G)
    params = {k: np.asarray(v) for k, v in
              jsg.generator_init(jax.random.PRNGKey(0), jcfg).items()}
    rng = np.random.RandomState(1)
    for k in params:
        if k.endswith("noise.weight") or k.endswith(".bias"):
            params[k] = params[k] + 0.1 * rng.randn(
                *params[k].shape).astype(np.float32)
    model = tg.Generator(tg.GeneratorConfig(**G))
    model.load_state_dict(params_from_jax(params), strict=True)
    return jcfg, params, model.requires_grad_(False)


def _z_and_noise(batch, seed):
    rng = np.random.RandomState(seed)
    z = rng.randn(batch, G["style_dim"]).astype(np.float32)
    noise = [rng.randn(*s).astype(np.float32)
             for s in tg.GeneratorConfig(**G).noise_shapes(batch)]
    return z, noise


def test_generator_bf16_matches_jax():
    jcfg, params, model = _generator_pair()
    z, noise = _z_and_noise(2, 3)
    ref = jax.jit(lambda p, z, n: jsg.generator_apply(
        p, jcfg, [z], noise=n, compute_dtype=BF16)[0])(
            jnp_tree(params), jnp.asarray(z), [jnp.asarray(n) for n in noise])
    ours, _ = model([torch.from_numpy(z)],
                    noise=[torch.from_numpy(n) for n in noise],
                    compute_dtype=torch.bfloat16)
    f32, _ = model([torch.from_numpy(z)],
                   noise=[torch.from_numpy(n) for n in noise])
    assert ref.dtype == jnp.float32 and ours.dtype == torch.float32
    err = rel_err(ours, ref)
    print(f"G bf16 vs JAX {err:.3e}, vs f32 {rel_err(ours, f32.numpy()):.3e}")
    assert err < 3e-2
    # the rounding shows: bfloat16 ran
    assert rel_err(ours, f32.numpy()) > 1e-4


# ---------------------------------------------------------------------------
# the perceptual losses
# ---------------------------------------------------------------------------

def _perceptual_pair(use_lins):
    """JAX's VGG16 (and lins) init with 0.05 noise on the trunk's biases,
    as bfloat16 JAX arrays, and the port's LPIPS holding the same values."""
    params = jlp.vgg16_init(jax.random.PRNGKey(0))
    if use_lins:
        params.update(jlp.lpips_lins_init(jax.random.PRNGKey(1)))
    params = {k: np.asarray(v) for k, v in params.items()}
    rng = np.random.RandomState(2)
    for k in params:
        if k.endswith(".bias"):
            params[k] = params[k] + 0.05 * rng.randn(
                *params[k].shape).astype(np.float32)
    params = _bf16_values(params)
    model = tlp.LPIPS(use_lins=use_lins).eval().requires_grad_(False)
    model.load_state_dict(params_from_jax(params), strict=True)
    return params, model


@pytest.mark.parametrize("kind", ["vgg_ssl", "lpips"])
def test_perceptual_bf16_matches_jax(kind):
    params, model = _perceptual_pair(kind == "lpips")
    rng = np.random.RandomState(4)
    x, y = (np.tanh(rng.randn(2, 3, 64, 64)).astype(np.float32)
            for _ in range(2))
    jfn = jlp.make_perceptual_loss(jlp.PerceptualLossConfig(
        kind=kind, compute_dtype="bfloat16"))
    ref = jfn(params, jnp.asarray(x), jnp.asarray(y))
    ours = tlp.make_perceptual_loss(kind, torch.bfloat16)(
        model, torch.from_numpy(x), torch.from_numpy(y))
    f32 = tlp.make_perceptual_loss(kind)(model, torch.from_numpy(x),
                                         torch.from_numpy(y))
    assert ours.dtype == torch.float32 and ours.shape == (2, 1, 1, 1)
    rel = np.abs(ours.numpy() - np.asarray(ref)) / np.abs(np.asarray(ref))
    print(f"{kind} bf16 vs JAX {rel.max():.3e}, vs f32 "
          f"{np.abs(ours.numpy() / f32.numpy() - 1).max():.3e}")
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-3)


# ---------------------------------------------------------------------------
# the STN
# ---------------------------------------------------------------------------

def _stn_pair():
    kw = dict(T, compute_dtype="bfloat16")
    jcfg = jstn.ComposedSTNConfig(**kw)
    params = perturb(jstn.composed_stn_init(jax.random.PRNGKey(1), jcfg), 5)
    model = tstn.ComposedSTN(tstn.ComposedSTNConfig(**kw))
    model.load_state_dict(params_from_jax(params), strict=True)
    return jcfg, params, model.eval().requires_grad_(False)


def _smooth_images(n, size, seed):
    """tanh of bilinearly upsampled 8x8 noise: images whose warped values
    move with their grids' rounding by a little, not by a pixel's jump."""
    low = torch.from_numpy(np.random.RandomState(seed).randn(
        n, 3, 8, 8).astype(np.float32))
    return torch.tanh(2 * F.interpolate(low, size=size, mode="bilinear"))


def test_composed_stn_bf16_matches_jax():
    jcfg, params, model = _stn_pair()
    x = _smooth_images(2, 64, 5)
    ref = jax.jit(lambda p, x: jstn.composed_stn_forward(p, jcfg, x)[:3])(
        jnp_tree(params), jnp.asarray(x.numpy()))
    ours = model(x)
    for name, o, r, tol in (("out", ours[0], ref[0], 0.2),
                            ("grid", ours[1], ref[1], 1e-2),
                            ("flow", ours[2], ref[2], 6e-3)):
        assert o.dtype == torch.float32
        err = float(np.abs(o.numpy() - np.asarray(r)).max())
        print(f"STN bf16 {name} vs JAX {err:.3e}")
        assert err < tol, name


def test_flagship_stn_bf16_against_f32():
    """The flagship congeal forward (similarity then flow, flow_size 128,
    256 px input, multiplier 0.5) with the smoke's seeded weights (the
    port's init plus 0.05 noise): its bfloat16 grids and flows against its
    float32 ones. A random encoder this deep carries a bfloat16 rounding
    of its features into the warps, so the gap is wide; the images, sampled
    at those grids, are printed only."""
    cfg = tstn.ComposedSTNConfig(transforms=("similarity", "flow"),
                                 flow_size=128, supersize=256,
                                 channel_multiplier=0.5)
    g = torch.Generator().manual_seed(0)
    f32 = tstn.ComposedSTN(cfg, generator=g).eval().requires_grad_(False)
    for p in f32.parameters():
        p.add_(0.05 * torch.randn(p.shape, generator=g))
    bf16 = tstn.ComposedSTN(dataclasses.replace(
        cfg, compute_dtype="bfloat16")).eval().requires_grad_(False)
    bf16.load_state_dict(f32.state_dict())
    x = _smooth_images(2, 256, 6)
    ours, ref = bf16(x), f32(x)
    errs = [float((o - r).abs().max()) for o, r in zip(ours[:3], ref[:3])]
    print("flagship bf16 vs f32 out {:.3e} grid {:.3e} flow {:.3e}".format(
        *errs))
    assert max(errs[1:]) < 1e-1


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def _to_bf16(s):
    """Make a training setup ``cli.train --compute_dtype bfloat16``'s: both
    G passes and the vgg_ssl trunk in bfloat16 on both sides, the JAX
    perceptual parameters cast to bfloat16 and the port's VGG holding
    their values."""
    s.vgg_params = _bf16_values(s.vgg_params)
    s.jploss = jlp.make_perceptual_loss(jlp.PerceptualLossConfig(
        kind="vgg_ssl", compute_dtype="bfloat16"))
    s.jcfg = dataclasses.replace(s.jcfg, compute_dtype="bfloat16")
    s.cfg = dataclasses.replace(s.cfg, compute_dtype="bfloat16")
    vgg = tlp.LPIPS().eval().requires_grad_(False)
    vgg.load_state_dict(params_from_jax(s.vgg_params), strict=True)
    loss = tlp.make_perceptual_loss("vgg_ssl", torch.bfloat16)
    s.perceptual_fn = lambda x, y: loss(vgg, x, y)
    return s


def _step_against_jax(s, t, ll, z, noise, grad_tol, l2_tol):
    """One step of each package from the same state: loss terms within
    1e-2 relative, the port's gradients against JAX's (its Adam's first
    moment over 0.1): each tensor within ``grad_tol`` of its largest JAX
    value, all of them within ``l2_tol`` in relative L2 norm."""
    sampler = Setup.jax_sampler(s, noise, BF16)
    step = jstate.make_train_step(s.jcfg, s.g_params, s.vgg_params, s.jploss,
                                  donate=False, pair_sampler=sampler)
    jst = jstate.init_train_state(jnp_tree(s.t_params), jnp_tree(s.ll_params))
    jst, terms = step(jst, jnp.asarray(z), jax.random.PRNGKey(0),
                      jnp.float32(PSI), jnp.float32(1e-3), jnp.float32(1e-2))
    state = tstate.TrainState(s.cfg, t, ll)
    metrics = tstate.train_step(state, s.generator, s.perceptual_fn,
                                torch.from_numpy(z), PSI, 1e-3, 1e-2,
                                noise=s.torch_noise(noise))
    term_err = {k: abs(float(metrics[k]) / float(terms[k]) - 1)
                for k in ("p", "tv", "f")}
    worst, ours, refs = {}, [], []
    for part, module in (("t", state.t), ("ll", state.ll)):
        for name, p in module.named_parameters():
            g_ref = np.asarray(jst[f"{part}_opt"].mu[name]) / 0.1
            worst[f"{part}.{name}"] = rel_err(p.grad, g_ref)
            ours.append(p.grad.numpy().ravel())
            refs.append(g_ref.ravel())
    ours, refs = np.concatenate(ours), np.concatenate(refs)
    l2 = float(np.linalg.norm(ours - refs) / np.linalg.norm(refs))
    print(f"terms {term_err}, worst tensor {max(worst.values()):.3e} "
          f"({max(worst, key=worst.get)}), L2 {l2:.3e}")
    for k, e in term_err.items():
        assert e < 1e-2, (k, e)
    bad = {k: v for k, v in worst.items() if v > grad_tol}
    assert not bad, bad
    assert l2 < l2_tol
    return metrics, state


def _grads(state):
    return np.concatenate([p.grad.numpy().ravel() for module in (
        state.t, state.ll) for p in module.parameters()])


def test_unimodal_bf16_step_matches_jax():
    """And against the port's float32 step from the same state: loss terms
    within 5e-2 relative, the gradients within 0.25 in relative L2 norm
    (over z seeds 6 to 11: 6.6e-4 to 2.6e-2; 2.1e-2 to 1.6e-1), the gate
    chip_smoke.py holds the card's bfloat16 cats step to against its
    float32 one."""
    s = _to_bf16(Setup(perturbed=True))
    z, noise = s.inputs(6)
    metrics, state = _step_against_jax(s, s.state.t, s.state.ll, z, noise,
                                       1e-1, 3e-2)
    f = Setup(perturbed=True)
    f32 = tstate.train_step(f.state, f.generator, f.perceptual_fn,
                            torch.from_numpy(z), PSI, 1e-3, 1e-2,
                            noise=f.torch_noise(noise))
    for k in ("p", "tv", "f"):
        assert abs(float(metrics[k]) / float(f32[k]) - 1) < 5e-2, k
    ours, ref = _grads(state), _grads(f.state)
    l2 = float(np.linalg.norm(ours - ref) / np.linalg.norm(ref))
    print(f"bf16 vs f32 step L2 {l2:.3e}")
    assert 1e-4 < l2 < 0.25


def test_clustered_bf16_step_matches_jax():
    """K = 2 with flips, as the cars recipe trains (full-resolution
    sampling, reflection padding), on z whose two least distances differ by
    more than BF16_TIE_GAP: the assignments equal."""
    s = _to_bf16(ClusterSetup(2, True))
    s.jcfg = dataclasses.replace(s.jcfg, sample_from_full_res=True,
                                 padding_mode="reflection")
    s.cfg = dataclasses.replace(s.cfg, sample_from_full_res=True,
                                padding_mode="reflection")
    z, noise = s.inputs(9)
    want = jlosses.assign_fake_images_to_clusters(
        s.g_params, s.jcfg.g, jnp_tree(s.t_params), s.jcfg.t,
        jnp_tree(s.ll_params), s.jcfg.ll, s.jpfn, jax.random.PRNGKey(0), PSI,
        2, 2, True, z=jnp.asarray(z), pair_sampler=Setup.jax_sampler(
            s, noise, BF16), sample_from_full_res=True,
        padding_mode="reflection")
    d = np.sort(np.asarray(want[6]), axis=1)
    assert ((d[:, 1] - d[:, 0]) / d[:, 0]).min() > BF16_TIE_GAP
    metrics, _ = _step_against_jax(s, s.t, s.ll, z, noise, 0.25, 8e-2)
    np.testing.assert_array_equal(metrics["assignments"].numpy(),
                                  np.asarray(want[1]))


# ---------------------------------------------------------------------------
# conv counts
# ---------------------------------------------------------------------------

def test_generator_conv_dtypes_match_jax():
    jcfg, params, model = _generator_pair()
    z, noise = _z_and_noise(2, 3)
    ref = _jax_conv_dtypes(
        lambda p, z: jsg.generator_apply(
            p, jcfg, [z], noise=[jnp.asarray(n) for n in noise],
            compute_dtype=BF16)[0], jnp_tree(params), jnp.asarray(z))
    with _ConvDtypes() as mode:
        model([torch.from_numpy(z)],
              noise=[torch.from_numpy(n) for n in noise],
              compute_dtype=torch.bfloat16)
    print("G", dict(mode.count), dict(ref))
    assert mode.count == ref
    # the skip's upsampling after the second ToRGB on, one at 16, 32, 64
    assert ref["float32"] == 3


def test_stn_conv_dtypes_match_jax():
    jcfg, params, model = _stn_pair()
    x = np.zeros((2, 3, 64, 64), np.float32)
    ref = _jax_conv_dtypes(
        lambda p, x: jstn.composed_stn_forward(p, jcfg, x)[0],
        jnp_tree(params), jnp.asarray(x))
    with _ConvDtypes() as mode:
        model(torch.from_numpy(x))
    print("STN", dict(mode.count), dict(ref))
    assert mode.count == ref


@pytest.mark.parametrize("kind", ["vgg_ssl", "lpips"])
def test_perceptual_conv_dtypes_match_jax(kind):
    params, model = _perceptual_pair(kind == "lpips")
    x = jnp.zeros((2, 3, 64, 64))
    jfn = jlp.make_perceptual_loss(jlp.PerceptualLossConfig(
        kind=kind, compute_dtype="bfloat16"))
    ref = _jax_conv_dtypes(jfn, params, x, x)
    with _ConvDtypes() as mode:
        tlp.make_perceptual_loss(kind, torch.bfloat16)(
            model, torch.zeros(2, 3, 64, 64), torch.zeros(2, 3, 64, 64))
    print(kind, dict(mode.count), dict(ref))
    assert mode.count == ref
    assert mode.count["bfloat16"] == 2 * 13


def test_float64_stays_float64():
    """The casts leave a float64 model in float64 (the smoke holds the
    card against a float64 CPU path): G's image, the STN's outputs and the
    perceptual distance come back float64."""
    _, _, g = _generator_pair()
    z, noise = _z_and_noise(2, 3)
    image, _ = g.double()([torch.from_numpy(z).double()],
                          noise=[torch.from_numpy(n).double() for n in noise])
    _, _, stn = _stn_pair()
    stn = tstn.ComposedSTN(dataclasses.replace(stn.cfg,
                                               compute_dtype="float32"))
    outs = stn.double()(_smooth_images(2, 64, 5).double())
    _, vgg = _perceptual_pair(True)
    d = tlp.make_perceptual_loss("lpips")(vgg.double(), image, image)
    assert image.dtype == d.dtype == torch.float64
    assert all(t.dtype == torch.float64 for t in outs[:3])
