"""Three GANgealing steps of the port against three of the JAX package's
``make_train_step``, and checkpoints carried between the two, on the CPU.

The small configuration of ``test_torch_train_common`` (vgg_ssl, batch 2), from
0.05-perturbed STN weights, z from seeds 6, 7 and 8, the generator's noise
fixed across the steps, psi 0.9, 0.6, 0.3 and learning rates 1e-5 (STN)
and 1e-4 (ll): a hundredth of the flagship's, so that the two
trajectories, which part by up to 2*lr where a gradient's sign flips (see
below), stay close enough for the later steps' gradients to be compared.

Tolerances. Adam moments within 1e-2 (first) and 2e-2 (second) of each
tensor's largest JAX value: the moments hold the three steps' gradients,
and a kink of the piecewise-smooth loss that flips between the frameworks
moves a gradient by about 1e-3 of its size (tests/test_torch_train_grads.py).
Measured: 8e-5 for both with 2 to 8 torch threads, 2.2e-3 and 3.3e-3 with
one, where the convs round otherwise and one more unit flips. Parameters
and the EMA: an element passes if it is within 1e-3 of the largest move
(3*lr), plus two float32 spacings of its value, of JAX's. An element that
is not is held to what the moments' tolerance allows it through Adam: a
step's update is about lr*g/|g|, so where the element's gradient g (JAX's,
read back from its first moments) is r of its tensor's largest, the bound
1e-2/r becomes an update error of about twice that, and the step may move
it by up to lr*min(2, 4*1e-2/r) the other way (2*lr: a sign flip where g
is within the tolerance of 0). The test counts these elements (27 of
504,302 here) and holds them under 1% of the parameters. Checkpoints carry
every tensor exactly.
"""

from importlib import import_module

import numpy as np
import torch
import jax
import jax.numpy as jnp

from gangealing_torch.train import checkpoint as tckpt
from gangealing_torch.train import state as tstate

from test_torch_train_common import (  # noqa: F401
    Setup, jnp_tree, jstate, rel_err, two_torch_threads)

jckpt = import_module("gangealing_tpu.train.checkpoint")
jio = import_module("gangealing_tpu.io.torch_import")

PSIS = (0.9, 0.6, 0.3)
LR_T, LR_LL = 1e-5, 1e-4
MU_TOL, NU_TOL = 1e-2, 2e-2


def _np(t):
    return t.detach().cpu().numpy().copy()


def _adam_moments(optim, names):
    """{name: (exp_avg, exp_avg_sq)} of a torch Adam over ``names``."""
    sd = optim.state_dict()["state"]
    return {n: (_np(sd[i]["exp_avg"]), _np(sd[i]["exp_avg_sq"]))
            for i, n in enumerate(names)}


def _run_both():
    s = Setup(perturbed=True)
    _, noise = s.inputs(0)
    step = jstate.make_train_step(
        s.jcfg, s.g_params, s.vgg_params, s.jploss, donate=False,
        pair_sampler=s.jax_sampler(noise))
    jst = jstate.init_train_state(jnp_tree(s.t_params), jnp_tree(s.ll_params))
    grads = []  # JAX's gradient of each step, from its first moments
    for k, psi in enumerate(PSIS):
        z, _ = s.inputs(6 + k)
        prev = jst
        jst, _ = step(jst, jnp.asarray(z), jax.random.PRNGKey(k),
                      jnp.float32(psi), jnp.float32(LR_T), jnp.float32(LR_LL))
        grads.append({
            part: {n: (np.asarray(jst[part].mu[n])
                       - 0.9 * np.asarray(prev[part].mu[n])) / 0.1
                   for n in jst[part].mu}
            for part in ("t_opt", "ll_opt")})
        tstate.train_step(s.state, s.generator, s.perceptual_fn,
                          torch.from_numpy(z), psi, LR_T, LR_LL,
                          noise=s.torch_noise(noise))
    return s, jst, grads


_CACHE = {}


def _trained():
    if "run" not in _CACHE:
        _CACHE["run"] = _run_both()
    return _CACHE["run"]


def _check_moved(ours, ref, step_grads, lr, counts):
    """Parameters or EMA after the steps against JAX's (module docstring):
    within 1e-3 of the largest move, or else within what the gradient
    tolerance allows each step's Adam update of the element."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    diff = np.abs(ours - ref)
    slack = 2 * np.spacing(np.abs(ref))
    tight = diff <= 1e-3 * len(step_grads) * lr + slack
    loose = slack
    for g in step_grads:
        rel_g = MU_TOL * np.abs(g).max() / np.maximum(np.abs(g), 1e-30)
        loose = loose + lr * np.minimum(2.0, 4 * rel_g)
    assert np.all(diff <= loose), (diff.max(), loose[diff > loose])
    counts[0] += int((~tight).sum())
    counts[1] += ours.size


def test_three_steps_match_jax():
    s, jst, grads = _trained()
    names_t = jio.learnable_key_order(s.state.t.state_dict())
    moments = _adam_moments(s.state.t_optim, names_t)
    counts = [0, 0]
    for name, p in s.state.t.named_parameters():
        mu, nu = moments[name]
        jmu = np.asarray(jst["t_opt"].mu[name])
        jnu = np.asarray(jst["t_opt"].nu[name])
        assert rel_err(mu, jmu) <= MU_TOL, name
        assert rel_err(nu, jnu) <= NU_TOL, name
        step_grads = [g["t_opt"][name] for g in grads]
        _check_moved(_np(p), jst["t"][name], step_grads, LR_T, counts)
        ema = dict(s.state.t_ema.named_parameters())[name]
        _check_moved(_np(ema), jst["t_ema"][name], step_grads, LR_T, counts)
    (mu, nu), = _adam_moments(s.state.ll_optim, ["coefficients"]).values()
    jmu = np.asarray(jst["ll_opt"].mu["coefficients"])
    assert rel_err(mu, jmu) <= MU_TOL
    assert rel_err(nu, jst["ll_opt"].nu["coefficients"]) <= NU_TOL
    _check_moved(_np(s.state.ll.coefficients), jst["ll"]["coefficients"],
                 [g["ll_opt"]["coefficients"] for g in grads], LR_LL, counts)
    # the buffers stay as they were, as the sampler keeps JAX's
    for k in ("directions", "lat_mean"):
        np.testing.assert_array_equal(_np(getattr(s.state.ll, k)),
                                      s.ll_params[k])
        np.testing.assert_array_equal(np.asarray(jst["ll"][k]),
                                      s.ll_params[k])
    assert int(s.state.t_optim.state_dict()["state"][0]["step"]) == 3
    print(f"elements outside 1e-3 of the largest move: {counts[0]} of "
          f"{counts[1]}")
    assert counts[0] <= 0.01 * counts[1]


def test_port_checkpoint_loads_in_jax(tmp_path):
    """A .pt the port wrote loads through the JAX package's
    load_torch_checkpoint and import_torch_adam_state, equal to the port's
    parameters and Adam moments."""
    s, _, _ = _trained()
    path = str(tmp_path / "0000003.pt")
    tckpt.save_checkpoint(path, s.state, s.generator, 3)
    ckpt = jio.load_torch_checkpoint(path)
    assert set(ckpt["_raw"]) == {"g_ema", "t", "t_ema", "ll", "t_optim",
                                 "ll_optim", "t_sched", "ll_sched", "args"}
    for part, module in (("t", s.state.t), ("t_ema", s.state.t_ema),
                         ("ll", s.state.ll), ("g_ema", s.generator)):
        sd = module.state_dict()
        assert set(ckpt[part]) == set(sd), part
        for k, v in sd.items():
            np.testing.assert_array_equal(ckpt[part][k], _np(v))
    t_opt = jio.import_torch_adam_state(ckpt["_raw"]["t_optim"], ckpt["t"])
    ll_opt = jio.import_torch_adam_state(ckpt["_raw"]["ll_optim"], ckpt["ll"])
    assert int(t_opt.count) == 3 and int(ll_opt.count) == 3
    names_t = jio.learnable_key_order(ckpt["t"])
    for n, (mu, nu) in _adam_moments(s.state.t_optim, names_t).items():
        np.testing.assert_array_equal(np.asarray(t_opt.mu[n]), mu)
        np.testing.assert_array_equal(np.asarray(t_opt.nu[n]), nu)
    (mu, nu), = _adam_moments(s.state.ll_optim, ["coefficients"]).values()
    np.testing.assert_array_equal(np.asarray(ll_opt.mu["coefficients"]), mu)
    np.testing.assert_array_equal(np.asarray(ll_opt.nu["coefficients"]), nu)


def test_jax_export_resumes_in_port(tmp_path):
    """A .pt that JAX's export_torch wrote resumes in the port with JAX's
    parameters and Adam moments, and the port steps on from it."""
    s, jst, _ = _trained()
    path = str(tmp_path / "0000003.pt")
    jckpt.export_torch(path, jax.tree.map(np.asarray, jst),
                       jax.tree.map(np.asarray, s.g_params),
                       train_cfg=s.jcfg, iteration=3)
    fresh = Setup(perturbed=False)
    tckpt.resume(fresh.state, tckpt.load_checkpoint(path))
    assert tckpt.parse_start_iter(path) == 3
    for part, module in (("t", fresh.state.t), ("t_ema", fresh.state.t_ema),
                         ("ll", fresh.state.ll)):
        for k, v in module.state_dict().items():
            np.testing.assert_array_equal(_np(v), np.asarray(jst[part][k]))
    names_t = jio.learnable_key_order(fresh.state.t.state_dict())
    for n, (mu, nu) in _adam_moments(fresh.state.t_optim, names_t).items():
        np.testing.assert_array_equal(mu, np.asarray(jst["t_opt"].mu[n]))
        np.testing.assert_array_equal(nu, np.asarray(jst["t_opt"].nu[n]))
    (mu, nu), = _adam_moments(fresh.state.ll_optim, ["coefficients"]).values()
    np.testing.assert_array_equal(mu, np.asarray(jst["ll_opt"].mu["coefficients"]))
    z, noise = fresh.inputs(9)
    before = _np(fresh.state.t.stns[0].warp_head.linear.weight)
    m = tstate.train_step(fresh.state, fresh.generator, fresh.perceptual_fn,
                          torch.from_numpy(z), 0.2, LR_T, LR_LL,
                          noise=fresh.torch_noise(noise))
    assert all(np.isfinite(float(v)) for v in m.values())
    assert int(fresh.state.t_optim.state_dict()["state"][0]["step"]) == 4
    assert not np.array_equal(before,
                              _np(fresh.state.t.stns[0].warp_head.linear.weight))
