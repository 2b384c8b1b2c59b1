"""Blocks of k training steps (``--scan_k``) in the port, on the CPU at
small widths: ``state.train_block`` against the JAX package's
``make_train_scan``; the port's loop with blocks against its loop of
single steps, to the bit; the checkpoints, visuals and logged scalars of
a blocked run at the JAX loop's iterations; a profiler window inside one
block; the CLI's choice of k; and a blocked run over two gloo ranks
against one process.

The cadence tests run the JAX loop with its step and scan replaced by
stubs that hand the state back: where the loop writes a checkpoint, draws
a visual or logs a scalar depends on the iterations alone, and the stubs
compile nothing.
"""

import json
import math
import os
from importlib import import_module

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import torch_parallel_worker as worker
from gangealing_torch.cli import train as tcli
from gangealing_torch.models import latent_learner as tll
from gangealing_torch.models import stn as tstn
from gangealing_torch.models import stylegan2 as tg
from gangealing_torch.parallel.launch import spawn_ranks
from gangealing_torch.train import checkpoint as tckpt
from gangealing_torch.train import loop as tloop
from gangealing_torch.train import state as tstate

from test_torch_train_cli import (  # noqa: F401
    _argv, _generator_checkpoint, _scalars, small_widths)
from test_torch_train_common import (  # noqa: F401
    G, LL, T, TRAIN, Setup, jnp_tree, jstate, rel_err, two_torch_threads)
from test_torch_train_steps import (
    LR_LL, LR_T, MU_TOL, NU_TOL, PSIS, _adam_moments, _check_moved, _np)

jsg = import_module("gangealing_tpu.models.stylegan2")
jstn = import_module("gangealing_tpu.models.stn")
jll = import_module("gangealing_tpu.models.latent_learner")
jloop = import_module("gangealing_tpu.train.loop")
jio = import_module("gangealing_tpu.io.torch_import")

# The block's loss terms against the JAX scan's, relative: the gate of
# tests/test_torch_train_grads.py's step-1 terms, for every step (read at
# most 3.1e-06, the second step's TV term)
TERMS_RTOL = 1e-5
SPAWN_TIMEOUT = 120


def _l2(x, y):
    return ((x - y) ** 2).mean(dim=(1, 2, 3), keepdim=True)


def _jl2(params, x, y):
    return jnp.mean((x - y) ** 2, axis=(1, 2, 3), keepdims=True)


# ---------------------------------------------------------------------------
# train_block against make_train_scan


def test_train_block_matches_make_train_scan():
    """Three steps in one block from 0.05-perturbed STN weights, psi 0.9,
    0.6, 0.3, z from seeds 6, 7 and 8 and the generator's noise fixed
    across the steps (JAX's scan closes over one pair sampler), against
    ``make_train_scan(k=3)`` on the same inputs, with an L2 perceptual
    loss: in the scan's loop body, compiled as the suite compiles (XLA's
    backend at level 0), JAX's VGG16 trunk took 35 s a step on an 8-core
    x86 CPU, and tests/test_torch_train_steps.py holds the steps with it.
    (At level 1 the loop ran fast, but LLVM fused the EMA's multiply-adds,
    and JAX's EMA alone parted from its single steps' by more than two
    float32 spacings in 1.3% of the elements.) The tolerances of
    tests/test_torch_train_steps.py: Adam's moments within 1e-2 (first)
    and 2e-2 (second) of each tensor's largest JAX value; parameters and
    the EMA within 1e-3 of the largest move or within what the moments'
    tolerance allows each step's Adam update (sized by the port's own
    gradient of each step, which the moments hold to JAX's), those outside
    1e-3 under 1% of the elements; the stacked loss terms within
    TERMS_RTOL."""
    s = Setup(perturbed=True)
    _, noise = s.inputs(0)
    zs = [s.inputs(6 + k)[0] for k in range(len(PSIS))]
    k = len(PSIS)
    scan = jstate.make_train_scan(s.jcfg, s.g_params, None, _jl2, k,
                                  donate=False,
                                  pair_sampler=s.jax_sampler(noise))
    jst = jstate.init_train_state(jnp_tree(s.t_params), jnp_tree(s.ll_params))
    jst, jm = scan(jst, jnp.asarray(np.stack(zs)),
                   jnp.stack([jax.random.PRNGKey(i) for i in range(k)]),
                   jnp.asarray(PSIS, jnp.float32),
                   jnp.full((k,), LR_T, jnp.float32),
                   jnp.full((k,), LR_LL, jnp.float32))

    grads = {"t": [], "ll": []}  # the port's gradient at each Adam step
    for part, optim in (("t", s.state.t_optim), ("ll", s.state.ll_optim)):
        names = jio.learnable_key_order(getattr(s.state, part).state_dict())
        optim.register_step_pre_hook(
            lambda o, a, kw, part=part, names=names: grads[part].append(
                {n: _np(p.grad) for n, p in zip(names,
                                                o.param_groups[0]["params"])}))
    metrics = tstate.train_block(
        s.state, s.generator, _l2,
        [torch.from_numpy(z) for z in zs], [s.torch_noise(noise)] * k,
        list(PSIS), [LR_T] * k, [LR_LL] * k)
    assert set(metrics) == {"p", "tv", "f"}
    for name in ("p", "tv", "f"):
        assert metrics[name].shape == (k,)
        for j in range(k):
            np.testing.assert_allclose(
                float(metrics[name][j]), float(jm[name][j]),
                rtol=TERMS_RTOL, err_msg=f"{name}[{j}]")

    names_t = jio.learnable_key_order(s.state.t.state_dict())
    moments = _adam_moments(s.state.t_optim, names_t)
    counts = [0, 0]
    for name, p in s.state.t.named_parameters():
        mu, nu = moments[name]
        assert rel_err(mu, jst["t_opt"].mu[name]) <= MU_TOL, name
        assert rel_err(nu, jst["t_opt"].nu[name]) <= NU_TOL, name
        step_grads = [g[name] for g in grads["t"]]
        _check_moved(_np(p), jst["t"][name], step_grads, LR_T, counts)
        ema = dict(s.state.t_ema.named_parameters())[name]
        _check_moved(_np(ema), jst["t_ema"][name], step_grads, LR_T, counts)
    (mu, nu), = _adam_moments(s.state.ll_optim, ["coefficients"]).values()
    assert rel_err(mu, jst["ll_opt"].mu["coefficients"]) <= MU_TOL
    assert rel_err(nu, jst["ll_opt"].nu["coefficients"]) <= NU_TOL
    _check_moved(_np(s.state.ll.coefficients), jst["ll"]["coefficients"],
                 [g["coefficients"] for g in grads["ll"]], LR_LL, counts)
    assert int(s.state.t_optim.state_dict()["state"][0]["step"]) == k
    assert int(jst["step"]) == k
    print(f"elements outside 1e-3 of the largest move: {counts[0]} of "
          f"{counts[1]}")
    assert counts[0] <= 0.01 * counts[1]


# ---------------------------------------------------------------------------
# The port's loop with blocks


def _port_state(cfg):
    """A seeded generator and a fresh state of the small configuration."""
    generator = tg.Generator(cfg.g, generator=torch.Generator().manual_seed(0))
    generator.requires_grad_(False)
    t = tstn.ComposedSTN(cfg.t, generator=torch.Generator().manual_seed(1))
    ll = tll.LatentLearner(cfg.ll, generator=torch.Generator().manual_seed(2))
    return generator, tstate.TrainState(cfg, t, ll)


def _config(**kw):
    return tstate.TrainConfig(
        g=tg.GeneratorConfig(**G), t=tstn.ComposedSTNConfig(**T),
        ll=tll.LatentLearnerConfig(**LL), **{**TRAIN, **kw})


def _run(tmp, name, cfg, **kw):
    generator, state = _port_state(cfg)
    results = str(tmp / name)
    os.makedirs(results)
    tloop.train_gangealing(state, generator, _l2, results, seed=3,
                           log_every=1, ckpt_every=0, vis_every=0, **kw)
    return state, results


def test_blocks_equal_single_steps_to_the_bit(tmp_path):
    """5 iterations as two blocks of 2 and a single-step tail against 5
    single steps: the parameters, the EMA, both Adams' moments and every
    logged scalar equal to the bit."""
    cfg = _config(iter=5, anneal_psi=2, period=1)
    runs = {k: _run(tmp_path, f"k{k}", cfg, scan_k=k) for k in (1, 2)}
    (one, dir1), (two, dir2) = runs[1], runs[2]
    for part in ("t", "ll", "t_ema"):
        a = getattr(one, part).state_dict()
        b = getattr(two, part).state_dict()
        for name in a:
            assert torch.equal(a[name], b[name]), (part, name)
    for part in ("t_optim", "ll_optim"):
        a = getattr(one, part).state_dict()["state"]
        b = getattr(two, part).state_dict()["state"]
        assert a.keys() == b.keys()
        for i in a:
            for key in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(a[i][key], b[i][key]), (part, i, key)
    assert int(one.t_optim.state_dict()["state"][0]["step"]) == 5

    def scalars(d):
        with open(os.path.join(d, "scalars.jsonl")) as f:
            return [json.loads(line) for line in f]
    assert scalars(dir1) == scalars(dir2)
    assert {s["step"] for s in scalars(dir1)} == set(range(1, 6))


def _jax_cadence(tmp, cfg_kw, monkeypatch, **kw):
    """The JAX loop's checkpoint and visual iterations (with each visual's
    psi), its block sizes and its logged (step, name) pairs, its step and
    scan stubbed (module docstring)."""
    jcfg = jstate.TrainConfig(g=jsg.GeneratorConfig(**G),
                              t=jstn.ComposedSTNConfig(**T),
                              ll=jll.LatentLearnerConfig(**LL),
                              **{**TRAIN, **cfg_kw})
    blocks, saved, vis = [], [], []

    def step(state, z, key, psi, lr_t, lr_ll):
        blocks.append(1)
        return state, {k: jnp.zeros(()) for k in ("p", "tv", "f")}

    def scan(state, zs, keys, psis, lr_ts, lr_lls):
        blocks.append(zs.shape[0])
        return state, {k: jnp.zeros(zs.shape[0]) for k in ("p", "tv", "f")}

    monkeypatch.setattr(jloop, "make_train_step", lambda *a, **k: step)
    monkeypatch.setattr(jloop, "make_train_scan", lambda *a, **k: scan)
    monkeypatch.setattr(jloop, "save_native", lambda path, *a, **k:
                        saved.append(int(os.path.basename(path))))
    monkeypatch.setattr(jloop, "export_torch", lambda *a, **k: None)
    monkeypatch.setattr(jloop, "create_training_visuals",
                        lambda *a, **k: vis.append((a[12], a[9])))
    g_params = jsg.generator_init(jax.random.PRNGKey(0), jcfg.g)
    t_params = jstn.composed_stn_init(jax.random.PRNGKey(1), jcfg.t)
    ll_params = jll.latent_learner_init(jax.random.PRNGKey(2), jcfg.ll)
    results = str(tmp / "jax")
    os.makedirs(results)
    jloop.train_gangealing(jcfg, g_params, t_params, ll_params, None, _jl2,
                           results, n_sample=2, n_mean=2, use_mesh=False,
                           progress=False, **kw)
    return saved, vis, blocks, _logged(results)


def _logged(results):
    with open(os.path.join(results, "scalars.jsonl")) as f:
        return sorted((s["step"], s["name"]) for s in map(json.loads, f))


CADENCES = {
    # the port's steps run: 10 iterations as blocks of 4 and a tail of 2,
    # a checkpoint every 3 and a zero of the learning rate (5) inside the
    # second block
    "checkpoints": (dict(iter=10, anneal_psi=6, period=100),
                    dict(scan_k=4, ckpt_every=3, log_every=4, vis_every=0)),
    # both loops' steps stubbed: 106 iterations in blocks of 8, the zeros
    # of the learning rate (6, 26, 66) and the early visual (100) inside
    # blocks
    "visuals": (dict(iter=106, anneal_psi=7, period=20),
                dict(scan_k=8, ckpt_every=50, log_every=25, vis_every=50)),
}


@pytest.mark.parametrize("case", CADENCES)
def test_cadence_matches_the_jax_loop(tmp_path, monkeypatch, case):
    """Checkpoints, visuals (each with its psi) and logged scalars of a
    blocked run at the iterations where JAX's ``train_gangealing`` writes
    them, and the blocks of the same sizes."""
    cfg_kw, kw = CADENCES[case]
    want_saved, want_vis, want_blocks, want_logged = _jax_cadence(
        tmp_path, cfg_kw, monkeypatch, **kw)
    blocks, vis = [], []
    if case == "visuals":
        def block(state, generator, pfn, zs, noises, psis, lr_ts, lr_lls):
            blocks.append(len(zs))
            return {k: torch.zeros(len(zs)) for k in ("p", "tv", "f")}
        monkeypatch.setattr(tloop, "train_block", block)
    monkeypatch.setattr(tloop, "create_training_visuals",
                        lambda *a, **k: vis.append((a[9], a[6])))
    cfg = _config(**cfg_kw)
    generator, state = _port_state(cfg)
    results = str(tmp_path / "port")
    os.makedirs(results)
    tloop.train_gangealing(state, generator, _l2, results, n_sample=2,
                           n_mean=2, **kw)
    saved = sorted(int(f[:-3]) for f in os.listdir(
        os.path.join(results, "checkpoints")))
    assert saved == sorted(want_saved)
    assert vis == want_vis
    assert _logged(results) == want_logged
    if case == "visuals":
        assert blocks == want_blocks
        assert [i for i, _ in vis] == [0, 8, 32, 56, 72, 104]
    else:
        assert saved == [4, 8, 9]
        assert int(state.t_optim.state_dict()["state"][0]["step"]) == 10


def test_profiler_window_inside_one_block(tmp_path, capsys):
    """A window (1, 3] inside the first block of 4 traces that block."""
    cfg = _config(iter=4, anneal_psi=2, period=1)
    trace_dir = tmp_path / "trace"
    _run(tmp_path, "run", cfg, scan_k=4, profile_dir=str(trace_dir),
         profile_start=1, profile_stop=3)
    traces = os.listdir(trace_dir)
    assert len(traces) == 1 and traces[0].endswith(".json")
    assert "trace of iterations 1..4" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# cli.train


@pytest.mark.parametrize("extra,k", [
    (["--batch", "2"], 8), (["--batch", "16"], 1),
    (["--batch", "16", "--scan_k", "3"], 3)])
def test_cli_picks_the_block_size(tmp_path, capsys, monkeypatch,
                                  small_widths, extra, k):
    """``--scan_k 0`` picks 8 under a per-rank batch of 16 and 1 from 16
    on, as the JAX CLI does; an explicit k is taken as given."""
    _generator_checkpoint(tmp_path)
    seen = []
    monkeypatch.setattr(tcli, "train_gangealing",
                        lambda *a, **kw: seen.append(kw["scan_k"]))
    tcli.main(_argv(tmp_path, 2, "--scan_k", "0", *extra))
    assert seen == [k]
    assert (f"scan_k={k}: blocks of {k}" in capsys.readouterr().out) == (k > 1)


def test_cli_trains_in_blocks(tmp_path, capsys, small_widths):
    """``--scan_k 4`` trains 5 iterations (a block of 4 and a single-step
    tail): finite scalars at every iteration, and one checkpoint, at the
    block's end, for the cadence points 1 and 2 (zeros of the learning
    rate) and 2 and 4 (``--ckpt_every 2``), where single steps write 1, 2
    and 4."""
    _generator_checkpoint(tmp_path)
    state, _, _, _ = tcli.main(_argv(tmp_path, 5, "--scan_k", "4"))
    assert "scan_k=4: blocks of 4" in capsys.readouterr().out
    scalars = _scalars(tmp_path)
    assert {s["step"] for s in scalars} == set(range(1, 6))
    assert all(math.isfinite(s["value"]) for s in scalars)
    ckpt_dir = tmp_path / "results" / "smoke" / "checkpoints"
    assert os.listdir(ckpt_dir) == ["0000004.pt"]
    assert int(state.t_optim.state_dict()["state"][0]["step"]) == 5
    ckpt = tckpt.load_checkpoint(ckpt_dir / "0000004.pt")
    assert int(ckpt["t_optim"]["state"][0]["step"]) == 4


def test_blocks_over_two_ranks_match_one_process(tmp_path, small_widths):
    """cli.train over two gloo ranks at 2 a rank in blocks of 2 (a block
    and a tail in 3 iterations) against one process at the global batch of
    4 in single steps: the logged loss terms within 1e-4 relative and the
    last checkpoint's STN and ll parameters within 1e-3 in relative L2,
    the gates of tests/test_torch_parallel.py's run in a group of one."""
    _generator_checkpoint(tmp_path)
    common = ("--ckpt_every", "3")
    spawn_ranks(worker.cli_train, 2, args=(_argv(
        tmp_path, 3, "--exp-name", "ranks", "--scan_k", "2", *common), 32),
        timeout=SPAWN_TIMEOUT)
    tcli.main(_argv(tmp_path, 3, "--exp-name", "one", "--batch", "4",
                    "--scan_k", "1", *common))
    runs = {}
    for name in ("one", "ranks"):
        run = tmp_path / "results" / name
        with open(run / "scalars.jsonl") as f:
            scalars = {(s["step"], s["name"]): s["value"] for s in map(
                json.loads, f) if s["name"].startswith("Loss/")}
        runs[name] = scalars, tckpt.load_checkpoint(
            run / "checkpoints" / "0000003.pt")
    (one, ckpt), (ranks, ckpt_r) = runs["one"], runs["ranks"]
    assert set(one) == set(ranks) and len(one) == 9
    for key, v in one.items():
        assert abs(ranks[key] - v) <= 1e-4 * abs(v), key
    for part in ("t", "ll"):
        a = torch.cat([torch.as_tensor(v).flatten().double()
                       for v in ckpt[part].values()])
        b = torch.cat([torch.as_tensor(ckpt_r[part][k]).flatten().double()
                       for k in ckpt[part]])
        assert float((a - b).norm() / a.norm()) <= 1e-3, part
