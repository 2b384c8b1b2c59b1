"""The port's multi-process runtime (gangealing_torch/parallel) on two gloo
ranks on the CPU, held against the JAX package's single-controller step
at the global batch, and at world 1 against what the training CLI logged
before the ranks drew their inputs ahead of the step.

One spawn runs every case (tests/torch_parallel_worker.py): two processes
on one host, each with the ``torchrun`` environment; the spawn and each
collective time out after SPAWN_TIMEOUT seconds, so a hang fails here in
seconds. The configurations are those of tests/test_torch_train_grads.py
and tests/test_torch_cluster_train.py at a global batch of 4, 2 a rank;
z and both generator passes' noise come from numpy, each rank keeps its
rows (``loop.rank_rows``), and JAX's step sees the whole batch.

Tolerances, each that of the single-process test it extends: the unimodal
step's loss terms 1e-5 relative and each gradient within 2e-3 of its
tensor's largest JAX value (tests/test_torch_train_grads.py); the
clustered step's assignments exactly, loss terms 1e-5, gradients 2e-2 a
tensor and 2e-3 in relative L2 (tests/test_torch_cluster_train.py); the
classifier's labels, accuracies and counts exactly, cross-entropy 1e-5,
gradients 1e-3 of the largest. Both ranks hold the same all-reduced
gradients to the bit, and they equal the mean of the two half-batch
gradients computed in one process (summed, then halved, as the all-reduce
does) to the bit. The classifier's training loop over the two ranks,
each drawing the global batch and keeping its rows, against the loop in
one process at the global batch: its last labels, accuracies and counts
exactly, cross-entropy 1e-5 relative, the classifier after two steps
within 1e-5 of each tensor's largest value (read 4.6e-07).
"""

import copy
import dataclasses
import json
from importlib import import_module

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import torch_parallel_worker as worker
from gangealing_torch.io import params_from_jax
from gangealing_torch.models import classifier as tcls
from gangealing_torch.parallel import mesh
from gangealing_torch.parallel.launch import spawn_ranks
from gangealing_torch.train import classifier_train as tct
from gangealing_torch.train import state as tstate
from gangealing_torch.train.loop import draw_step_inputs, rank_rows

from gangealing_torch.cli import train as tcli
from test_torch_cluster_train import ClusterSetup
from test_torch_train_cli import (  # noqa: F401
    _argv, _generator_checkpoint, _scalars, small_widths)
from test_torch_train_common import (  # noqa: F401
    G, Setup, jnp_tree, jlosses, jstate, rel_err, two_torch_threads)

jcls = import_module("gangealing_tpu.models.classifier")
jct = import_module("gangealing_tpu.train.classifier_train")

WORLD, GLOBAL = 2, 4
SPAWN_TIMEOUT = 120
PSI, LR_T, LR_LL, CLS_LR = 0.7, 1e-3, 1e-2, 1e-3
TIE_GAP = 1e-4
LOOP_ITERS = 2
CLS_CFG = jcls.ClassifierConfig(size=64, supersize=64,
                                channel_multiplier=0.25, num_heads=4,
                                max_channels=32)


def _global_inputs(cfg, seed):
    """z (GLOBAL, style_dim) and both passes' noise, the second at
    GLOBAL * K rows, as numpy."""
    rng = np.random.RandomState(seed)
    K = cfg.t.num_heads
    z = rng.randn(GLOBAL, G["style_dim"]).astype(np.float32)
    noise = [[rng.randn(*s).astype(np.float32)
              for s in cfg.g.noise_shapes(b)] for b in (GLOBAL, GLOBAL * K)]
    return z, noise


def _torch(z, noise):
    return torch.from_numpy(z), tuple(
        [torch.from_numpy(x) for x in ns] for ns in noise)


def _noisy(s):
    """G's noise weights at 0.3 on both sides (0 at init, where the noise
    would not reach the images), so that each rank's noise rows count."""
    s.g_params = {k: np.full_like(np.asarray(v), 0.3)
                  if k.endswith("noise.weight") else v
                  for k, v in s.g_params.items()}
    s.generator.load_state_dict(params_from_jax(s.g_params), strict=True)
    return s


def _case(s, cfg, z, noise, t, ll, **extra):
    return dict(cfg=cfg, g=s.generator.state_dict(), t=t.state_dict(),
                ll=ll.state_dict(), vgg=params_from_jax(s.vgg_params),
                z=torch.from_numpy(z), noise=_torch(z, noise)[1], **extra)


class Cases:
    """The three steps' set-ups and inputs, on both sides."""

    def __init__(self):
        self.uni = _noisy(Setup(perturbed=True))
        self.uni_cfg = dataclasses.replace(self.uni.cfg, batch=GLOBAL)
        self.uni_in = _global_inputs(self.uni_cfg, 6)
        self.clu = _noisy(ClusterSetup(2, True))
        kw = dict(batch=GLOBAL, sample_from_full_res=True,
                  padding_mode="reflection")
        self.clu_cfg = dataclasses.replace(self.clu.cfg, **kw)
        self.clu_jcfg = dataclasses.replace(self.clu.jcfg, **kw)
        self.clu_in = _global_inputs(self.clu_cfg, 7)
        # JAX's classifier step draws its own noise: G's noise weights stay
        # at 0 there
        self.cls = ClusterSetup(2, True)
        self.cls_cfg = dataclasses.replace(
            self.cls.cfg, batch=GLOBAL, sample_from_full_res=True)
        self.cls_jcfg = dataclasses.replace(
            self.cls.jcfg, batch=GLOBAL, sample_from_full_res=True)
        self.cls_in = _global_inputs(self.cls_cfg, 8)
        params = jct.warm_start_from_stn(
            jcls.classifier_init(jax.random.PRNGKey(5), CLS_CFG),
            jnp_tree(self.cls.t_params))
        self.cls_params = {k: np.asarray(v) for k, v in params.items()}

    def data(self):
        uni, clu, cls = self.uni, self.clu, self.cls
        return {
            "unimodal": _case(uni, self.uni_cfg, *self.uni_in, uni.state.t,
                              uni.state.ll, psi=PSI, lr_t=LR_T,
                              lr_ll=LR_LL),
            "clustered": _case(clu, self.clu_cfg, *self.clu_in, clu.t,
                               clu.ll, psi=PSI, lr_t=LR_T, lr_ll=LR_LL),
            "classifier": _case(
                cls, self.cls_cfg, *self.cls_in, cls.t, cls.ll,
                classifier=params_from_jax(self.cls_params),
                cls_cfg=tcls.ClassifierConfig(**CLS_CFG.__dict__),
                lr=CLS_LR),
            "classifier_loop": self.loop_case()}

    def loop_case(self):
        """The classifier's training loop at the global batch, G's noise
        weights at 0.3 so that each rank's noise rows count."""
        s = self.cls
        g = {k: torch.full_like(v, 0.3) if k.endswith("noise.weight")
             else v for k, v in s.generator.state_dict().items()}
        return dict(cfg=self.cls_cfg, g=g, t=s.t.state_dict(),
                    ll=s.ll.state_dict(), vgg=params_from_jax(s.vgg_params),
                    classifier=params_from_jax(self.cls_params),
                    cls_cfg=tcls.ClassifierConfig(**CLS_CFG.__dict__),
                    lr=CLS_LR, iters=LOOP_ITERS, seed=9)


@pytest.fixture(scope="module")
def cases():
    return Cases()


@pytest.fixture(scope="module")
def ranks(cases, tmp_path_factory):
    """Each case's results on each rank: {case: [rank 0's, rank 1's]}."""
    out = tmp_path_factory.mktemp("ranks")
    data = str(out / "data.pt")
    torch.save(cases.data(), data)
    spawn_ranks(worker.run, WORLD, args=(data, str(out)),
                timeout=SPAWN_TIMEOUT)
    return {case: [torch.load(out / f"{case}_r{r}.pt", weights_only=False)
                   for r in range(WORLD)]
            for case in ("helpers", "unimodal", "clustered", "classifier",
                         "classifier_loop")}


def _same_on_both(results, *keys):
    for k in keys:
        a, b = results[0][k], results[1][k]
        for name in a:
            assert torch.equal(a[name], b[name]), (k, name)


def _halves_mean(make_state, step, z, noise, K):
    """The gradients of each half of the global batch in this process,
    from the same state, summed and halved as the all-reduce does."""
    halves = []
    for r in range(WORLD):
        nr = ([x[r * 2:(r + 1) * 2] for x in noise[0]],
              [x[r * 2 * K:(r + 1) * 2 * K] for x in noise[1]])
        halves.append(step(make_state(), z[r * 2:(r + 1) * 2], nr))
    return {part: {n: (halves[0][part][n] + halves[1][part][n]) / WORLD
                   for n in halves[0][part]} for part in halves[0]}


def test_helpers_across_two_ranks(ranks):
    h = ranks["helpers"]
    assert h[0]["stripe"] == [0, 2, 4] and h[1]["stripe"] == [1, 3]
    for r in range(WORLD):
        np.testing.assert_array_equal(
            h[r]["gathered"], np.arange(5, dtype=np.float32)[:, None]
            * [1, 10])
        # the empty stripe took rank 0's trailing shape and dtype
        assert h[r]["empty"].dtype == np.int16
        np.testing.assert_array_equal(h[r]["empty"],
                                      np.full((1, 2, 3), 7, np.int16))
        np.testing.assert_array_equal(h[r]["gatherv"], [0, 1, 2, 10])
        np.testing.assert_array_equal(h[r]["hosts"],
                                      [[[0, 0]], [[1, -1]]])
        torch.testing.assert_close(h[r]["rows"],
                                   torch.arange(8).reshape(4, 2)[2 * r:
                                                                 2 * r + 2])
        assert torch.equal(h[r]["broadcast"], torch.zeros(2, 3))
        # d/dW of sum(W x + b) is x: (1 + 2) / 2 on both ranks
        assert torch.equal(h[r]["grad"], torch.full((2, 3), 1.5))
        assert torch.equal(h[r]["mean"], torch.tensor([1.5, 3.0]))
        assert h[r]["world"] == WORLD and h[r]["primary"] == (r == 0)


def test_helpers_at_world_one():
    """No process group: every helper is the identity or a no-op."""
    assert not torch.distributed.is_initialized()
    assert mesh.world_size() == 1 and mesh.rank() == 0 and mesh.is_primary()
    assert mesh.process_stripe(3) == [0, 1, 2]
    x = np.arange(6).reshape(3, 2)
    np.testing.assert_array_equal(mesh.gather_process_stripes([x], 2),
                                  x[:2])
    assert mesh.all_gather_hosts(x) is x
    np.testing.assert_array_equal(mesh.all_gatherv_hosts(x), x)
    t = torch.arange(4)
    assert mesh.shard_global_batch(t) is t
    assert mesh.mean_over_ranks(t) is t
    mesh.host_barrier()
    lin = torch.nn.Linear(2, 2)
    lin(torch.ones(1, 2)).sum().backward()
    before = lin.weight.grad.clone()
    mesh.all_reduce_grads(lin)
    assert torch.equal(lin.weight.grad, before)


@pytest.mark.parametrize("r", range(WORLD))
def test_rank_rows_follow_the_latent_learners_layout(r, monkeypatch):
    """Rank r keeps z's rows [2r, 2r + 2) and, of the pass at N*K images,
    the K rows of each of its samples: rows n*K + k."""
    monkeypatch.setattr(mesh, "rank", lambda: r)
    monkeypatch.setattr(mesh, "world_size", lambda: WORLD)
    z = torch.arange(4.0)[:, None]
    n_u = [torch.arange(4.0)[:, None, None, None]]
    n_a = [torch.arange(12.0)[:, None, None, None]]  # K = 3
    zr, (nu, na) = rank_rows(z, (n_u, n_a), 3)
    assert zr.flatten().tolist() == [2 * r, 2 * r + 1]
    assert nu[0].flatten().tolist() == [2 * r, 2 * r + 1]
    assert na[0].flatten().tolist() == list(range(6 * r, 6 * r + 6))


def test_draws_keep_the_generators_order():
    """draw_step_inputs draws z, then the first pass's noise, then the
    second's, as the step drew them itself from the same generator."""
    cfg = Setup().cfg
    from gangealing_torch.models import stylegan2 as tg
    g = tg.Generator(cfg.g)
    z, (n_u, n_a) = draw_step_inputs(g, torch.Generator().manual_seed(3), 2, 2)
    rng = torch.Generator().manual_seed(3)
    assert torch.equal(z, torch.randn(2, cfg.g.style_dim, generator=rng))
    for got, n in ((n_u, 2), (n_a, 4)):
        for a, b in zip(got, g.make_noise(n, rng)):
            assert torch.equal(a, b)


def _port_step(cfg, t, ll, s):
    def make_state():
        return tstate.TrainState(cfg, copy.deepcopy(t), copy.deepcopy(ll))

    def step(state, z, noise):
        tstate.train_step(state, s.generator, s.perceptual_fn, z, PSI, LR_T,
                          LR_LL, noise=noise)
        return {"t": worker._grads(state.t), "ll": worker._grads(state.ll)}
    return make_state, step


def _jax_grads(jst):
    return {part: {n: np.asarray(jst[f"{part}_opt"].mu[n]) / 0.1
                   for n in jst[f"{part}_opt"].mu} for part in ("t", "ll")}


def test_unimodal_step_on_two_ranks_matches_jax(cases, ranks):
    s, res = cases.uni, ranks["unimodal"]
    z, noise = cases.uni_in
    jcfg = dataclasses.replace(s.jcfg, batch=GLOBAL)
    step = jstate.make_train_step(jcfg, s.g_params, s.vgg_params, s.jploss,
                                  donate=False,
                                  pair_sampler=s.jax_sampler(noise))
    jst = jstate.init_train_state(jnp_tree(s.t_params), jnp_tree(s.ll_params))
    jst, terms = step(jst, jnp.asarray(z), jax.random.PRNGKey(0),
                      jnp.float32(PSI), jnp.float32(LR_T),
                      jnp.float32(LR_LL))
    _same_on_both(res, "t", "ll")
    for r in range(WORLD):
        for k in ("p", "tv", "f"):
            np.testing.assert_allclose(float(res[r]["metrics"][k]),
                                       float(terms[k]), rtol=1e-5,
                                       atol=1e-12, err_msg=k)
    want = _jax_grads(jst)
    bad = {n: rel_err(res[0][part][n], want[part][n])
           for part in ("t", "ll") for n in res[0][part]
           if rel_err(res[0][part][n], want[part][n]) > 2e-3}
    assert not bad, bad
    halves = _halves_mean(*_port_step(s.cfg, s.state.t, s.state.ll, s),
                          *_torch(z, noise), 1)
    for part in ("t", "ll"):
        for n, g in halves[part].items():
            assert torch.equal(res[0][part][n], g), (part, n)


def test_clustered_step_on_two_ranks_matches_jax(cases, ranks):
    s, res = cases.clu, ranks["clustered"]
    jcfg = cases.clu_jcfg
    z, noise = cases.clu_in
    sampler = s.jax_sampler(noise)
    want_idx = jlosses.assign_fake_images_to_clusters(
        s.g_params, jcfg.g, jnp_tree(s.t_params), jcfg.t,
        jnp_tree(s.ll_params), jcfg.ll, s.jpfn, jax.random.PRNGKey(0), PSI,
        GLOBAL, 2, True, z=jnp.asarray(z), pair_sampler=sampler,
        sample_from_full_res=True, padding_mode="reflection")
    d = np.sort(np.asarray(want_idx[6]), axis=1)
    assert ((d[:, 1] - d[:, 0]) / np.abs(d[:, 0])).min() > TIE_GAP
    step = jstate.make_train_step(jcfg, s.g_params, s.vgg_params, s.jploss,
                                  donate=False, pair_sampler=sampler)
    jst = jstate.init_train_state(jnp_tree(s.t_params), jnp_tree(s.ll_params))
    jst, terms = step(jst, jnp.asarray(z), jax.random.PRNGKey(0),
                      jnp.float32(PSI), jnp.float32(LR_T),
                      jnp.float32(LR_LL))
    _same_on_both(res, "t", "ll")
    assignments = np.concatenate([res[r]["metrics"]["assignments"].numpy()
                                  for r in range(WORLD)])
    np.testing.assert_array_equal(assignments, np.asarray(want_idx[1]))
    for r in range(WORLD):
        for k in ("p", "tv", "f"):
            np.testing.assert_allclose(float(res[r]["metrics"][k]),
                                       float(terms[k]), rtol=1e-5,
                                       atol=1e-12, err_msg=k)
    want = _jax_grads(jst)
    ours, refs, bad = [], [], {}
    for part in ("t", "ll"):
        for n, g in res[0][part].items():
            ours.append(g.numpy().ravel())
            refs.append(want[part][n].ravel())
            if rel_err(g, want[part][n]) > 2e-2:
                bad[n] = rel_err(g, want[part][n])
    assert not bad, bad
    ours, refs = np.concatenate(ours), np.concatenate(refs)
    assert np.linalg.norm(ours - refs) <= 2e-3 * np.linalg.norm(refs)
    halves = _halves_mean(*_port_step(cases.clu_cfg, s.t, s.ll, s),
                          *_torch(z, noise), 2)
    for part in ("t", "ll"):
        for n, g in halves[part].items():
            assert torch.equal(res[0][part][n], g), (part, n)


def test_classifier_step_on_two_ranks_matches_jax(cases, ranks):
    s, res = cases.cls, ranks["classifier"]
    jcfg = cases.cls_jcfg
    z, noise = cases.cls_in
    step = jct.make_classifier_train_step(
        jcfg, CLS_CFG, s.g_params, jnp_tree(s.t_params),
        jnp_tree(s.ll_params), s.vgg_params, s.jploss)
    opt = jstate.adam().init(jnp_tree(cases.cls_params))
    _, opt, jm = step(jnp_tree(cases.cls_params), opt, jax.random.PRNGKey(3),
                      jnp.float32(CLS_LR), jnp.asarray(z))
    labels = jlosses.assign_fake_images_to_clusters(
        s.g_params, jcfg.g, jnp_tree(s.t_params), jcfg.t,
        jnp_tree(s.ll_params), jcfg.ll, s.jpfn, jax.random.PRNGKey(3), 0.0,
        GLOBAL, 2, True, freeze_ll=True, sample_from_full_res=True,
        z=jnp.asarray(z))
    d = np.sort(np.asarray(labels[6]), axis=1)
    assert ((d[:, 1] - d[:, 0]) / np.abs(d[:, 0])).min() > TIE_GAP
    _same_on_both(res, "grads", "params")
    np.testing.assert_array_equal(
        np.concatenate([res[r]["metrics"]["labels"].numpy()
                        for r in range(WORLD)]), np.asarray(labels[1]))
    m = res[0]["metrics"]
    np.testing.assert_allclose(float(m["cross_entropy"]),
                               float(jm["cross_entropy"]), rtol=1e-5)
    for k in ("acc@1", "acc@2", "gt_counts", "pred_counts"):
        np.testing.assert_array_equal(m[k].numpy(), np.asarray(jm[k]), k)
    for name, g in res[0]["grads"].items():
        assert rel_err(g, np.asarray(opt.mu[name]) / 0.1) <= 1e-3, name
    # the same step on each half in this process, summed and halved
    classifier = tcls.Classifier(tcls.ClassifierConfig(**CLS_CFG.__dict__))
    halves = []
    zt, nt = _torch(z, noise)
    for r in range(WORLD):
        classifier.load_state_dict(params_from_jax(cases.cls_params),
                                   strict=True)
        trainer = tct.ClassifierTrainer(cases.cls_cfg, classifier,
                                        s.generator, s.t.eval(), s.ll,
                                        s.perceptual_fn, cls_lr=CLS_LR)
        trainer.step(zt[2 * r:2 * r + 2], CLS_LR, noise=(
            [x[2 * r:2 * r + 2] for x in nt[0]],
            [x[4 * r:4 * r + 4] for x in nt[1]]))
        halves.append(worker._grads(classifier))
    for n, g in res[0]["grads"].items():
        assert torch.equal(g, (halves[0][n] + halves[1][n]) / WORLD), n


def _loop_trainer(d):
    """The classifier trainer of a loop case, in this process."""
    generator, t, ll, pfn = worker._modules(d)
    classifier = tcls.Classifier(d["cls_cfg"])
    classifier.load_state_dict(d["classifier"], strict=True)
    return tct.ClassifierTrainer(d["cfg"], classifier, generator, t.eval(),
                                 ll, pfn, cls_lr=d["lr"])


def _params(trainer):
    return {k: v.detach().clone()
            for k, v in trainer.classifier.state_dict().items()}


def test_classifier_loop_on_two_ranks_matches_one_process(cases, ranks):
    """train_cluster_classifier over two ranks, each drawing the global
    batch of 4 and keeping its 2 rows, against the same loop in one
    process at the global batch: the last step's labels exactly, its
    cross-entropy within 1e-5 relative, its accuracies and counts exactly,
    and the classifier after LOOP_ITERS steps within 1e-5 of each
    tensor's largest value (the two runs sum the batch's gradient in
    another order); both ranks hold the same classifier to the bit."""
    res = ranks["classifier_loop"]
    d = cases.data()["classifier_loop"]
    trainer = _loop_trainer(d)
    want = tct.train_cluster_classifier(trainer, LOOP_ITERS, cls_lr=CLS_LR,
                                        seed=d["seed"], progress=False)
    _same_on_both(res, "params")
    np.testing.assert_array_equal(
        np.concatenate([res[r]["metrics"]["labels"].numpy()
                        for r in range(WORLD)]), want["labels"].numpy())
    m = res[0]["metrics"]
    np.testing.assert_allclose(float(m["cross_entropy"]),
                               float(want["cross_entropy"]), rtol=1e-5)
    for k in ("acc@1", "acc@2", "gt_counts", "pred_counts"):
        np.testing.assert_array_equal(m[k].numpy(), want[k].numpy(), k)
    for name, p in _params(trainer).items():
        assert rel_err(res[0]["params"][name], p.numpy()) <= 1e-5, name


def test_classifier_loop_at_world_one_draws_as_before(cases):
    """At world 1 the loop, which draws z and both passes' noise ahead of
    the step, trains the classifier to the bit as when it drew z and let
    the step draw the noise from the iteration's generator."""
    from gangealing_torch.train.annealing import lr_used_at_iter
    from gangealing_torch.train.loop import iteration_rng
    d = cases.data()["classifier_loop"]
    new = _loop_trainer(d)
    tct.train_cluster_classifier(new, LOOP_ITERS, cls_lr=CLS_LR,
                                 seed=d["seed"], progress=False)
    old = _loop_trainer(d)
    for i in range(1, LOOP_ITERS + 1):
        rng = iteration_rng(d["seed"], i, torch.device("cpu"))
        z = torch.randn(GLOBAL, G["style_dim"], generator=rng)
        old.step(z, lr_used_at_iter(i, CLS_LR, 0, 2500.0, t_mult=2,
                                    decay=0.9), rng=rng)
    for name, p in _params(old).items():
        assert torch.equal(_params(new)[name], p), name


def test_classifier_loop_refuses_a_batch_the_world_does_not_divide(
        cases, monkeypatch):
    monkeypatch.setattr(tct, "world_size", lambda: 3)
    with pytest.raises(ValueError, match="divisible by the world size"):
        tct.train_cluster_classifier(
            _loop_trainer(cases.data()["classifier_loop"]), 1,
            progress=False)


# Loss terms of iterations 1 to 3 of the CLI run below, as the training
# loop logged them when train_step drew each generator pass's noise itself
# from the iteration's generator (an 8-core x86 CPU, two torch threads):
# drawing z and both passes' noise ahead of the step, in the same order,
# logs the same values to the bit at world 1.
WORLD1_SCALARS = {
    "unimodal": [
        (0.023251375183463097, 0.0, 0.0),
        (0.046091340482234955, 9.838471305556595e-05, 0.0024000483099371195),
        (0.068292036652565, 5.568233063968364e-06, 0.0003661401569843292)],
    "clustered": [
        (0.018608907237648964, 0.0, 0.0),
        (0.04180413484573364, 3.6871912016067654e-05, 0.0006218547350727022),
        (0.05691488832235336, 2.066118577204179e-05, 0.0011106798192486167)]}


@pytest.mark.parametrize("case", ["unimodal", "clustered"])
def test_world_one_cli_logs_what_it_logged(tmp_path, small_widths, case):
    """A seeded CPU cli.train run of 3 iterations, without torchrun, logs
    WORLD1_SCALARS (relative 1e-6: another CPU's convolutions may round
    otherwise; another draw order moves them by about 1e-2)."""
    _generator_checkpoint(tmp_path)
    extra = ["--num_heads", "2", "--flips"] if case == "clustered" else []
    tcli.main(_argv(tmp_path, 3, *extra))
    names = ("Loss/Reconstruction", "Loss/TotalVariation", "Loss/FlowIdentity")
    got = {(s["step"], s["name"]): s["value"] for s in _scalars(tmp_path)}
    for i, want in enumerate(WORLD1_SCALARS[case], 1):
        np.testing.assert_allclose([got[(i, n)] for n in names], want,
                                   rtol=1e-6, atol=0, err_msg=f"step {i}")


def test_cli_train_in_a_group_of_one_matches_the_plain_run(tmp_path,
                                                           small_widths):
    """cli.train in a gloo group of one rank, as ``torchrun
    --nproc_per_node 1`` starts it, against the same command without a
    group: its logged loss terms within 1e-4 relative and its last
    checkpoint's STN and ll parameters within 1e-3 in relative L2, the
    gates of chip_smoke.py's NCCL run at world 1 (both read 0 here: the
    all-reduce of one rank and its division by 1 change no bit)."""
    from gangealing_torch.train.checkpoint import load_checkpoint
    _generator_checkpoint(tmp_path)
    runs = {}
    for name in ("plain", "group"):
        argv = _argv(tmp_path, 2, "--exp-name", name)
        if name == "plain":
            tcli.main(argv)
        else:
            spawn_ranks(worker.cli_train, 1, args=(argv, 32),
                        timeout=SPAWN_TIMEOUT)
        run = tmp_path / "results" / name
        with open(run / "scalars.jsonl") as f:
            scalars = {(s["step"], s["name"]): s["value"] for s in map(
                json.loads, f) if s["name"].startswith("Loss/")}
        runs[name] = scalars, load_checkpoint(run / "checkpoints" /
                                              "0000002.pt")
    (plain, ckpt), (group, ckpt_g) = runs["plain"], runs["group"]
    assert set(plain) == set(group) and len(plain) == 6
    for k, v in plain.items():
        assert abs(group[k] - v) <= 1e-4 * abs(v), k
    for part in ("t", "ll"):
        a = torch.cat([torch.as_tensor(v).flatten().double()
                       for v in ckpt[part].values()])
        b = torch.cat([torch.as_tensor(ckpt_g[part][k]).flatten().double()
                       for k in ckpt[part]])
        assert float((a - b).norm() / a.norm()) <= 1e-3, part
