"""The port's training visuals, flow colouring, the loop's visuals and
profiler window against the JAX package's, on the CPU.

The small training configuration of ``test_torch_train_common`` (G 64 px,
the STN at flow_size 64 with 0.05 noise on its weights, vgg_ssl) and its
clustering form of ``test_torch_cluster_train``; z and every generator
pass's noise come from numpy and go to both packages (JAX's visuals draw
them from keys, which torch cannot reproduce).

Tolerances: ``flow_to_rgb`` equal to the bit; the composed forward's
``unfold`` and ``return_intermediates`` out 5e-4 and grids 1e-4, as
tests/test_torch_stn.py; every image array handed to the writer 5e-4
(OUT_TOL) and the colour-coded flows within one uint8 level (flows
within 1e-4 may cross a level's floor); the cluster assignments equal
(on seeds whose two least distances differ by 1e-4 relative); the PNG
names and the scalar lines equal; the loop's visual iterations and the
profiler window's first and last step equal, and its refusals' messages.
"""

import json
import os
from importlib import import_module

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gangealing_torch.io import params_from_jax
from gangealing_torch.models import latent_learner as tll
from gangealing_torch.models import stn as tstn
from gangealing_torch.models import stylegan2 as tg
from gangealing_torch.train import loop as tloop
from gangealing_torch.train import state as tstate
from gangealing_torch.train import visuals as tvis
from gangealing_torch.train.state import TrainState
from gangealing_torch.utils import flow_vis as tflow
from gangealing_torch.utils import profiling as tprof

from test_torch_train_common import (  # noqa: F401
    G, LL, T, Setup, jlosses, jnp_tree, jll, jsg, jstate, jstn, perturb,
    two_torch_threads)
from test_torch_cluster_train import ClusterSetup

jvis = import_module("gangealing_tpu.train.visuals")
jloop = import_module("gangealing_tpu.train.loop")
jflow = import_module("gangealing_tpu.utils.flow_vis")

OUT_TOL, GRID_TOL, RGB_TOL = 5e-4, 1e-4, 1.0 / 255 + 1e-6
PSI = 0.6
S = T["flow_size"]


def reals(seed, n):
    """Smooth real images in [-1, 1]: tanh of upsampled 8x8 noise."""
    low = np.random.RandomState(seed).randn(n, 3, 8, 8).astype(np.float32)
    return np.tanh(2 * np.kron(low, np.ones((1, 1, S // 8, S // 8),
                                            np.float32)))


# ---------------------------------------------------------------------------
# flow colouring, the composed forward's options, the trace
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("case", ["test_vis", "large", "clipped",
                                  "unscaled"])
def test_flow_to_rgb_equals_jax(case, per_sample):
    rng = np.random.RandomState(0)
    flow = rng.randn(2, 16, 16, 2).astype(np.float32) * 0.1  # test_vis's
    kw = {}
    if case == "large":
        flow = rng.randn(3, 24, 20, 2).astype(np.float32) * 2
    elif case == "clipped":
        kw["clip_flow"] = 0.05
    elif case == "unscaled":
        kw["scale_by_resolution"] = False
    ours = tflow.flow_to_rgb(flow, per_sample_normalize=per_sample, **kw)
    ref = jflow.flow_to_rgb(flow, per_sample_normalize=per_sample, **kw)
    assert ours.dtype == np.uint8 and ours.shape == flow.shape[:3] + (3,)
    np.testing.assert_array_equal(ours, ref)


def _composed(K, transforms):
    arch = dict(T, num_heads=K, transforms=transforms)
    cfg = jstn.ComposedSTNConfig(**arch)
    params = perturb(jstn.composed_stn_init(jax.random.PRNGKey(1), cfg), 5)
    model = tstn.ComposedSTN(tstn.ComposedSTNConfig(**arch))
    model.load_state_dict(params_from_jax(params), strict=True)
    return cfg, jnp_tree(params), model.eval()


@pytest.mark.parametrize("K,transforms", [
    (1, ("similarity", "flow")), (2, ("similarity",)),
    (2, ("similarity", "flow"))])
def test_unfold_and_intermediates_match_jax(K, transforms):
    """``unfold`` reshapes the last stage to (N, K, ...) and
    ``return_intermediates`` lists each stage's (out, grid), as JAX's
    composed_stn_forward. JAX's flow head cannot unfold the N K streams
    that a composed K-head forward hands it (models/stn.py:303-306
    reshapes them to (N K, K, ...)), so there the reference is its forward
    without unfold, reshaped."""
    cfg, params, model = _composed(K, transforms)
    x = reals(3, 3)
    kw = dict(padding_mode="reflection")
    with torch.no_grad():
        ours = model(torch.from_numpy(x), unfold=True, **kw)
        inter = model(torch.from_numpy(x), return_intermediates=True, **kw)
    jx = jnp.asarray(x)

    def jfwd(**opts):
        return jax.jit(lambda p, a: jstn.composed_stn_forward(
            p, cfg, a, **opts, **kw))(params, jx)
    if K > 1 and len(transforms) > 1:
        with pytest.raises(TypeError):
            jfwd(unfold=True)
        ref = [np.asarray(t).reshape(3, K, *t.shape[1:])
               for t in jfwd()[:3]]
    else:
        ref = jfwd(unfold=True)
    for o, r, tol in zip(ours[:3], ref[:3], (OUT_TOL, GRID_TOL, GRID_TOL)):
        assert o.shape == (3, K) + tuple(o.shape[2:])
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=tol, rtol=0)
    ref_inter = jfwd(return_intermediates=True)
    assert len(inter) == len(ref_inter) == len(transforms)
    for (o, g), (ro, rg) in zip(inter, ref_inter):
        np.testing.assert_allclose(o.numpy(), np.asarray(ro), atol=OUT_TOL,
                                   rtol=0)
        np.testing.assert_allclose(g.numpy(), np.asarray(rg), atol=GRID_TOL,
                                   rtol=0)


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "t")):
        (torch.ones(8, 8) @ torch.ones(8, 8)).sum()
    files = os.listdir(tmp_path / "t")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "t" / files[0]) as f:
        assert json.load(f)["traceEvents"]


# ---------------------------------------------------------------------------
# the visuals functions
# ---------------------------------------------------------------------------

class Recorder:
    """Wrap a writer's log_image_grid: record each call's arrays, then
    write the PNGs as the writer does."""

    def __init__(self, writer):
        self.calls = []
        orig = writer.log_image_grid

        def log(images, name, itr, *a, **kw):
            self.calls.append((name, itr, np.array(
                images.detach().cpu() if torch.is_tensor(images) else images)))
            return orig(images, name, itr, *a, **kw)
        writer.log_image_grid = log


def _writers(tmp_path):
    ours = tvis.GANgealingWriter(str(tmp_path / "ours"))
    ref = jvis.GANgealingWriter(str(tmp_path / "ref"))
    return ours, ref, Recorder(ours), Recorder(ref)


def _assert_same_visuals(tmp_path, rec_ours, rec_ref):
    assert [(n, i) for n, i, _ in rec_ours.calls] == \
        [(n, i) for n, i, _ in rec_ref.calls]
    for (name, _, o), (_, _, r) in zip(rec_ours.calls, rec_ref.calls):
        assert o.shape == r.shape, name
        tol = RGB_TOL if name == "flow_real" else OUT_TOL
        np.testing.assert_allclose(o, r, atol=tol, rtol=0, err_msg=name)
    pngs = [sorted(f for f in os.listdir(tmp_path / d) if f.endswith(".png"))
            for d in ("ours", "ref")]
    assert pngs[0] == pngs[1] and pngs[0]


def _noise(cfg, batches, seed):
    rng = np.random.RandomState(seed)
    return [[rng.randn(*s).astype(np.float32) for s in cfg.g.noise_shapes(b)]
            for b in batches]


def _jit_sampler(s, noise):
    """The JAX pair sampler on the numpy noise, jitted (the JAX visuals
    run op by op, which costs more here than one compile)."""
    sampler = jax.jit(s.jax_sampler(noise), static_argnums=3)
    return lambda ll_params, key, psi, batch, z: sampler(
        ll_params, key, psi, batch, z)


def jitted_forward(orig):
    """``orig`` (JAX's composed_stn_forward) jitted for each configuration
    and set of static options, its array arguments traced: op by op it
    compiles hundreds of small programs in these tests."""
    fns = {}

    def forward(params, cfg, x, **kw):
        arrays = {k: v for k, v in kw.items()
                  if isinstance(v, (jax.Array, np.ndarray))}
        static = tuple(sorted((k, v) for k, v in kw.items()
                              if k not in arrays))
        key = (cfg, static, tuple(sorted(arrays)))
        if key not in fns:
            fns[key] = jax.jit(lambda p, a, arr: orig(
                p, cfg, a, **dict(static), **arr))
        return fns[key](params, x, arrays)
    return forward


@pytest.fixture
def jit_jax_stn(monkeypatch):
    """JAX's composed_stn_forward jitted where its visuals and losses call
    it."""
    forward = jitted_forward(jstn.composed_stn_forward)
    monkeypatch.setattr(jvis, "composed_stn_forward", forward)
    monkeypatch.setattr(jlosses, "composed_stn_forward", forward)


def _patch_pairs(monkeypatch, s, noise):
    """Both packages' sample_gan_supervised_pairs in the visuals module
    take the numpy noise."""
    sampler = _jit_sampler(s, noise)
    monkeypatch.setattr(
        jvis, "sample_gan_supervised_pairs",
        lambda g, gc, llp, llc, key, psi, batch, flow_size, freeze_ll=False,
        z=None: sampler(llp, key, psi, batch, z))
    orig = tvis.sample_gan_supervised_pairs
    monkeypatch.setattr(tvis, "sample_gan_supervised_pairs",
                        lambda *a, **kw: orig(*a, **{
                            **kw, "noise": s.torch_noise(noise)}))


@pytest.mark.parametrize("with_reals", [True, False])
def test_training_visuals_match_jax(tmp_path, monkeypatch, jit_jax_stn,
                                    with_reals):
    """create_training_visuals (and through it run_loader_mean and
    create_fake_visuals) with a loader of 5 reals in batches of 3 and
    n_mean 4 (the whole second batch is taken, as JAX takes it), and
    without one."""
    s = Setup(perturbed=True)
    z = np.random.RandomState(11).randn(3, G["style_dim"]).astype(np.float32)
    _patch_pairs(monkeypatch, s, _noise(s.cfg, (3, 3), 12))
    imgs = reals(13, 5)
    loader = [imgs[:3], imgs[3:]] if with_reals else None
    sample_reals = imgs[:2] if with_reals else None
    ours, ref, rec_ours, rec_ref = _writers(tmp_path)
    kw = dict(padding_mode="reflection")
    tvis.create_training_visuals(
        s.generator, s.state.t, s.state.ll, loader, sample_reals,
        torch.from_numpy(z), PSI, 4, 2, 7, ours, **kw)
    jvis.create_training_visuals(
        s.g_params, s.jcfg.g, jnp_tree(s.t_params), s.jcfg.t,
        jnp_tree(s.ll_params), s.jcfg.ll, loader, sample_reals,
        jnp.asarray(z), PSI, 4, 2, 7, ref, jax.random.PRNGKey(0), **kw)
    names = [n for n, _, _ in rec_ours.calls]
    assert names == (["mean_EMA_transformed_real_sample",
                      "EMA_transformed_real_sample", "flow_real"]
                     if with_reals else []) + [
        "sample", "transformed_sample", "truncated_sample"]
    _assert_same_visuals(tmp_path, rec_ours, rec_ref)


def _jax_loader_mean_reshaped(orig):
    """JAX's run_loader_mean with ``unfold`` done by a reshape of its
    forward (its flow head cannot unfold a composed K-head forward)."""
    def run(t_params, t_cfg, loader, max_eles=12000, unfold=False, **kw):
        outs, _ = orig(t_params, t_cfg, loader, max_eles, **kw)
        if unfold:
            outs = outs.reshape(-1, t_cfg.num_heads, *outs.shape[1:])
        return outs, outs.mean(axis=0, keepdims=True)
    return run


@pytest.mark.parametrize("K,flips", [(2, True), (4, False)])
def test_training_cluster_visuals_match_jax(tmp_path, monkeypatch,
                                            jit_jax_stn, K, flips):
    """create_training_cluster_visuals over 3 fakes in chunks of 2 (a tail
    of 1), with a loader of 3 reals: each head's congealed reals and mean,
    the fakes' assigned heads, each head's mean and samples, then the
    fake visuals. Each chunk's z is big_z's on both sides (JAX's draws its
    own from a key) and the noise is numpy's."""
    s = ClusterSetup(K, flips)
    rng = np.random.RandomState(20)
    big_z = rng.randn(3, G["style_dim"]).astype(np.float32)
    z = rng.randn(1, G["style_dim"]).astype(np.float32)
    chunks = [(big_z[i:i + 2], _noise(s.cfg, (len(big_z[i:i + 2]),
                                              len(big_z[i:i + 2]) * K), 21 + i))
              for i in range(0, 3, 2)]
    calls = {"ours": 0, "ref": 0}

    def jassign(g, gc, t, tc, llp, llc, pfn, key, psi, batch, k, fl,
                freeze_ll=False, **kw):
        zc, noise = chunks[calls["ref"]]
        calls["ref"] += 1
        assert batch == len(zc)
        return jassign_orig(g, gc, t, tc, llp, llc, pfn, key, psi, batch, k,
                            fl, freeze_ll=freeze_ll, z=jnp.asarray(zc),
                            pair_sampler=_jit_sampler(s, noise), **kw)

    def tassign(*a, **kw):
        _, noise = chunks[calls["ours"]]
        calls["ours"] += 1
        return tassign_orig(*a, noise=s.torch_noise(noise), **kw)

    jassign_orig = jvis.assign_fake_images_to_clusters
    tassign_orig = tvis.assign_fake_images_to_clusters
    monkeypatch.setattr(jvis, "assign_fake_images_to_clusters", jassign)
    monkeypatch.setattr(tvis, "assign_fake_images_to_clusters", tassign)
    monkeypatch.setattr(jvis, "run_loader_mean",
                        _jax_loader_mean_reshaped(jvis.run_loader_mean))
    _patch_pairs(monkeypatch, s, _noise(s.cfg, (1, K), 30))
    imgs = reals(31, 3)
    ours, ref, rec_ours, rec_ref = _writers(tmp_path)
    kw = dict(padding_mode="reflection")
    with torch.no_grad():
        tvis.create_training_cluster_visuals(
            s.generator, s.t, s.ll, s.perceptual_fn, [imgs[:2], imgs[2:]],
            torch.from_numpy(z), torch.from_numpy(big_z), PSI, 4, 3, K,
            flips, 2, 9, ours, **kw)
    jvis.create_training_cluster_visuals(
        s.g_params, s.jcfg.g, jnp_tree(s.t_params), s.jcfg.t,
        jnp_tree(s.ll_params), s.jcfg.ll, jax.jit(s.jpfn),
        [imgs[:2], imgs[2:]],
        jnp.asarray(z), jnp.asarray(big_z), PSI, 4, 3, K, flips, 2, 9, ref,
        jax.random.PRNGKey(0), **kw)
    assert calls == {"ours": 2, "ref": 2}
    names = [n for n, _, _ in rec_ours.calls]
    assert names[:K + 1] == ["mean_EMA_transformed_real_sample"] + [
        f"EMA_head_{k}" for k in range(K)]
    assert "mean_generated_EMA_transformed_assigned" in names
    _assert_same_visuals(tmp_path, rec_ours, rec_ref)


def test_writer_scalars_and_animation(tmp_path):
    """The same scalar lines as JAX's writer; animate_visuals turns the
    numbered PNGs into an mp4, as JAX's does."""
    rng = np.random.RandomState(0)
    for w in (tvis.GANgealingWriter(str(tmp_path / "ours")),
              jvis.GANgealingWriter(str(tmp_path / "ref"))):
        w.add_scalar("Loss/Reconstruction", np.float32(0.25), 3)
        w.add_scalar("Progress/psi", 1, 4)
        for i in range(3):
            w.log_image_grid(rng.rand(4, 3, 8, 8) * 2 - 1, "sample", i, 4)
    lines = [open(tmp_path / d / "scalars.jsonl").read()
             for d in ("ours", "ref")]
    assert lines[0] == lines[1] and lines[0].count("\n") == 2
    for d, fn in (("ours", tvis.animate_visuals),
                  ("ref", jvis.animate_visuals)):
        out = str(tmp_path / d / "sample.mp4")
        assert fn(str(tmp_path / d), "sample", out, fps=5) == 3
        assert os.path.getsize(out) > 0
    assert tvis.animate_visuals(str(tmp_path), "none",
                                str(tmp_path / "x.mp4")) == 0


def test_writer_tensorboard_opt_in(tmp_path):
    """log_images_to_tb=True writes each scalar to a TensorBoard event
    file as well; scalars.jsonl is the same as without it."""
    from tensorboard.backend.event_processing.event_file_loader import (
        EventFileLoader)
    from tensorboard.util.tensor_util import make_ndarray
    for d, tb in (("tb", True), ("plain", False)):
        w = tvis.GANgealingWriter(str(tmp_path / d), log_images_to_tb=tb)
        w.add_scalar("Loss/Reconstruction", np.float32(0.25), 3)
        w.close()
    lines = [open(tmp_path / d / "scalars.jsonl").read()
             for d in ("tb", "plain")]
    assert lines[0] == lines[1]
    events = [f for f in os.listdir(tmp_path / "tb")
              if f.startswith("events.out.tfevents")]
    assert len(events) == 1
    assert not any(f.startswith("events")
                   for f in os.listdir(tmp_path / "plain"))
    scalars = [(v.tag, e.step, float(make_ndarray(v.tensor)))
               for e in EventFileLoader(
                   str(tmp_path / "tb" / events[0])).Load()
               for v in e.summary.value]
    assert scalars == [("Loss/Reconstruction", 3, 0.25)]


# ---------------------------------------------------------------------------
# the loop: when it draws visuals and where its profiler window sits
# ---------------------------------------------------------------------------

LOOP = dict(batch=2, anneal_psi=10, period=5, tm=2, iter=104)


def _jax_loop_events(monkeypatch, tmp_path, start_iter, **kw):
    """The JAX loop's visuals and trace calls, in order, with its step
    replaced by one that only counts."""
    jcfg = jstate.TrainConfig(
        g=jsg.GeneratorConfig(**G), t=jstn.ComposedSTNConfig(**T),
        ll=jll.LatentLearnerConfig(**LL), **LOOP)
    events = []
    done = [start_iter]

    def make_step(*a, **k):
        def step(state, z, key, psi, lr_t, lr_ll):
            done[0] += 1
            m = jnp.zeros(())
            return state, {"p": m, "tv": m, "f": m}
        return step
    monkeypatch.setattr(jloop, "make_train_step", make_step)
    monkeypatch.setattr(jloop, "create_training_visuals",
                        lambda *a, **k: events.append(("vis", a[12])))
    monkeypatch.setattr(jax.profiler, "start_trace",
                        lambda d: events.append(("start", done[0] + 1)))
    monkeypatch.setattr(jax.profiler, "stop_trace",
                        lambda: events.append(("stop", done[0])))
    results = str(tmp_path / "jax")
    os.makedirs(results, exist_ok=True)
    jloop.train_gangealing(
        jcfg, {}, {}, {}, None, None, results, start_iter=start_iter,
        resume_state={"t_ema": {}, "ll": {}}, n_sample=2, n_mean=2,
        log_every=1000, ckpt_every=0, use_mesh=False, progress=False, **kw)
    return events


def _port_loop_events(monkeypatch, tmp_path, start_iter, **kw):
    cfg = tstate.TrainConfig(g=tg.GeneratorConfig(**G),
                             t=tstn.ComposedSTNConfig(**T),
                             ll=tll.LatentLearnerConfig(**LL), **LOOP)
    state = TrainState(cfg, tstn.ComposedSTN(cfg.t),
                       tll.LatentLearner(cfg.ll))
    generator = tg.Generator(cfg.g)
    events = []
    done = [start_iter]

    def block(state, generator, perceptual_fn, zs, *a, **k):
        done[0] += len(zs)
        m = torch.zeros(len(zs))
        return {"p": m, "tv": m, "f": m}
    monkeypatch.setattr(tloop, "train_block", block)
    monkeypatch.setattr(tloop, "create_training_visuals",
                        lambda *a, **k: events.append(("vis", a[9])))
    monkeypatch.setattr(tloop, "start_trace",
                        lambda: events.append(("start", done[0] + 1))
                        or "profiler")
    monkeypatch.setattr(tloop, "stop_trace",
                        lambda prof, d: events.append(("stop", done[0])))
    results = str(tmp_path / "port")
    os.makedirs(results, exist_ok=True)
    tloop.train_gangealing(state, generator, None, results,
                           start_iter=start_iter, n_sample=2, n_mean=2,
                           log_every=1000, ckpt_every=0, **kw)
    return events


@pytest.mark.parametrize("start_iter", [0, 37])
def test_loop_visuals_and_profiler_window_match_jax(tmp_path, monkeypatch,
                                                    start_iter):
    """Visuals at the start, every vis_every, at 100 and at every zero of
    the learning rate; the trace over steps (2, 5] of this run, counted
    from start_iter in a resumed run."""
    kw = dict(vis_every=30, profile_dir=str(tmp_path / "trace"),
              profile_start=2, profile_stop=5)
    ours = _port_loop_events(monkeypatch, tmp_path, start_iter, **kw)
    ref = _jax_loop_events(monkeypatch, tmp_path, start_iter, **kw)
    assert ours == ref
    vis = [i for e, i in ours if e == "vis"]
    assert vis[0] == start_iter and 100 in vis and 90 in vis
    assert ("start", start_iter + 3) in ours and \
        ("stop", start_iter + 5) in ours


@pytest.mark.parametrize("window", [(2, 2), (60, 80), (100, 200)])
def test_profiler_window_checks_match_jax(tmp_path, monkeypatch, window):
    """A window that is empty or starts past the run's last step is
    refused with JAX's message; one reaching past it ends with the run."""
    kw = dict(vis_every=0, profile_dir=str(tmp_path / "trace"),
              profile_start=window[0], profile_stop=window[1])
    errors = []
    for run in (_port_loop_events, _jax_loop_events):
        try:
            errors.append(run(monkeypatch, tmp_path, 37, **kw))
        except ValueError as e:
            errors.append(str(e))
    assert errors[0] == errors[1]
    if window == (100, 200):
        assert isinstance(errors[0], str) and "past" in errors[0]
    elif window == (2, 2):
        assert "must be >" in errors[0]
    else:
        assert errors[0] == [("start", 98), ("stop", 104)]
