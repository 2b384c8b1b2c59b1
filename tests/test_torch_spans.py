"""The port's stage spans (utils/profiling.py::span, unit_spans).

On the CPU: with no profiler on a span records nothing; under
``torch.profiler`` one train step of a small configuration (G 64 px, the
similarity-then-flow STN at flow_size 64, vgg_ssl, batch 2; and its form
with 2 heads and flips) records its stages as one tree rooted at
``train.step``; every span lands in the trace as a ``cpu_op``, never as a
``user_annotation`` (which kineto would copy onto the device's timeline);
only spans inside a root take timing events, which the record reuses; the
record keeps at most ``RECORD_CAP`` spans; a step's losses and parameters
are the same to the bit with the profiler on and off. The generator's
last two synthesis blocks open ``generator.top`` once a pass, and the
card's pyramid build ``stn.pyramid`` once a warp (on the CPU the card's
path runs with a plain stand-in for its kernels; the CPU's own warp opens
none); with no profiler on neither records a span or makes a timing
event; the benchmark's readers of the two spans read nothing from a
program that lacks them.

On the card (marker ``cuda``): a profiled congeal forward puts no span
on the device's timeline, opens ``stn.pyramid`` inside each warp, and
each stage's device-clock ms is positive and inside the forward's.
"""

import collections
import os
import sys
import threading
import time
import types

import pytest
import torch

from gangealing_torch.models import latent_learner as tll
from gangealing_torch.models import lpips as tlp
from gangealing_torch.models import stn as tstn
from gangealing_torch.models import stylegan2 as tg
from gangealing_torch.ops import mipmap as tmipmap
from gangealing_torch.train import state as tstate
from gangealing_torch.utils import profiling
from gangealing_torch.utils.profiling import span, unit_spans

G = dict(size=64, style_dim=32, n_mlp=2, channel_multiplier=1,
         max_channels=32)
T = dict(transforms=("similarity", "flow"), flow_size=64, supersize=64,
         channel_multiplier=0.25, flow_downsample=4, max_channels=32)
LL = dict(n_comps=2, inject_index=3, n_latent=10, style_dim=32)
TRAIN = dict(batch=2, tv_weight=1000.0, flow_identity_weight=1.0,
             anneal_psi=100, period=50, loss_fn="vgg_ssl")
CONFIGS = {"unimodal": dict(num_heads=1, flips=False),
           "two heads, flips": dict(num_heads=2, flips=True)}
# spans a step holds, and each one's parent
STEP = {"train.step": (1, None), "train.generator": (2, "train.step"),
        "generator.top": (2, "train.generator"),
        "stn.composed": (1, "train.step"),
        "stn.features": (2, "stn.composed"),
        "stn.sample": (2, "stn.composed"),
        "train.perceptual": (1, "train.step"),
        "train.backward": (1, "train.step"),
        "train.update": (1, "train.step")}
CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def fresh_record():
    """An empty record and two torch threads for each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    profiling._RECORD.clear()
    yield
    profiling._RECORD.clear()
    torch.set_num_threads(n)


class Step:
    """The port's modules of the small configuration, drawn from seeded
    generators, and one step's inputs."""

    def __init__(self, num_heads, flips):
        gen = torch.Generator().manual_seed(0)
        cfg = tstate.TrainConfig(
            g=tg.GeneratorConfig(**G),
            t=tstn.ComposedSTNConfig(**T, num_heads=num_heads),
            ll=tll.LatentLearnerConfig(**LL, num_heads=num_heads),
            flips=flips, sample_from_full_res=num_heads > 1, **TRAIN)
        self.generator = tg.Generator(cfg.g, generator=gen)
        self.generator.requires_grad_(False)
        t = tstn.ComposedSTN(cfg.t, generator=gen)
        ll = tll.LatentLearner(cfg.ll, generator=gen)
        self.state = tstate.TrainState(cfg, t, ll)
        vgg = tlp.LPIPS(generator=gen).eval().requires_grad_(False)
        loss = tlp.make_perceptual_loss("vgg_ssl")
        self.perceptual_fn = lambda x, y: loss(vgg, x, y)
        self.z = torch.randn(TRAIN["batch"], G["style_dim"], generator=gen)
        self.noise = tuple(
            [torch.randn(s, generator=gen)
             for s in cfg.g.noise_shapes(TRAIN["batch"] * k)]
            for k in (1, num_heads))

    def run(self):
        return tstate.train_step(self.state, self.generator,
                                 self.perceptual_fn, self.z, 0.6, 1e-3, 1e-2,
                                 noise=self.noise)

    def learned(self):
        st = self.state
        return {f"{prefix}.{k}": v.detach().clone()
                for prefix, m in (("t", st.t), ("ll", st.ll),
                                  ("t_ema", st.t_ema))
                for k, v in m.named_parameters()}


def profiled_events(fn):
    with torch.profiler.profile(activities=CPU) as prof:
        out = fn()
    return out, list(prof.profiler.kineto_results.events())


def test_no_profiler_no_record():
    with span("test.off"):
        with span("test.off.inner"):
            pass
    Step(**CONFIGS["unimodal"]).run()
    assert len(profiling._RECORD) == 0
    assert unit_spans("test.off", 1) == []
    assert unit_spans("train.step", 1) == []


@pytest.mark.parametrize("config", CONFIGS)
def test_train_step_records_its_stages(config):
    step = Step(**CONFIGS[config])
    profiled_events(step.run)
    units = unit_spans("train.step", 5)
    assert len(units) == 1
    unit = units[0]
    assert unit[0].name == "train.step" and unit[0].parent is None
    counts = collections.Counter(s.name for s in unit)
    assert counts == {name: n for name, (n, _) in STEP.items()}
    for s in unit:
        assert s.parent == STEP[s.name][1], s
        if not torch.cuda.is_initialized():
            assert s.device_ms is None  # events only where a card is used
    # each STN stage: its encoder, then its sampling
    stages = [s.name for s in unit if s.parent == "stn.composed"]
    assert stages == ["stn.features", "stn.sample"] * 2


def test_spans_are_host_ops_not_annotations():
    step = Step(**CONFIGS["unimodal"])
    _, events = profiled_events(step.run)
    spans = [e for e in events if e.name() in STEP]
    assert collections.Counter(e.name() for e in spans) == \
        {name: n for name, (n, _) in STEP.items()}
    for e in spans:
        assert not e.is_user_annotation(), e.name()
        assert e.device_type() == torch.autograd.DeviceType.CPU


class FakeEvent:
    """A CUDA timing event's stand-in: counts what is made and recorded."""
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        FakeEvent.made += 1
        self.records = 0

    def record(self):
        self.records += 1

    def elapsed_time(self, end):
        assert self.records and end.records
        return 1.5


def test_only_spans_inside_a_root_take_events(monkeypatch):
    """A root (a unit) records no timing events, each span inside one a
    pair; events of spans the record dropped are used again."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(profiling, "_EVENTS", [])
    monkeypatch.setattr(profiling, "RECORD_CAP", 6)
    monkeypatch.setattr(FakeEvent, "made", 0)
    n = 10

    def units():
        for _ in range(n):
            with span("test.root"):
                with span("test.stage"):
                    with span("test.inner"):
                        pass
    profiled_events(units)
    got = unit_spans("test.root", n)
    assert len(got) == profiling.RECORD_CAP // 3
    assert all([(s.name, s.parent, s.device_ms) for s in u] ==
               [("test.root", None, None),
                ("test.inner", "test.stage", 1.5),
                ("test.stage", "test.root", 1.5)] for u in got)
    # 4 spans of the record and 2 open hold events; without reuse, 2 * 2n
    assert FakeEvent.made <= 2 * (4 + 2) < 2 * 2 * n


def test_record_keeps_its_cap():
    n = profiling.RECORD_CAP + 10

    def many():
        for i in range(n):
            with span("test.root"):
                with span("test.child"):
                    pass
    profiled_events(many)
    assert len(profiling._RECORD) == profiling.RECORD_CAP
    units = unit_spans("test.root", n)
    assert len(units) == profiling.RECORD_CAP // 2
    assert all([s.name for s in u] == ["test.root", "test.child"]
               for u in units)


def test_each_thread_keeps_its_own_parents():
    def other():
        with span("test.other"):
            time.sleep(0.01)

    def main():
        with span("test.main"):
            t = threading.Thread(target=other)
            t.start()
            t.join()
    profiled_events(main)
    assert [[s.name for s in u] for u in unit_spans("test.main", 2)] == \
        [["test.main"]]
    assert [[s.name for s in u] for u in unit_spans("test.other", 2)] == \
        [["test.other"]]


def test_threads_lose_no_span():
    """More threads than cores open nested spans at once, the interpreter
    switching threads every microsecond: every span is kept, under the
    parent its own thread opened."""
    threads = (os.cpu_count() or 1) + 2
    reps = profiling.RECORD_CAP // (2 * threads) - 1

    def worker(k):
        for _ in range(reps):
            with span(f"stress.{k}"):
                with span(f"stress.{k}.child"):
                    pass

    def run_all():
        pool = [threading.Thread(target=worker, args=(k,))
                for k in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        profiled_events(run_all)
    finally:
        sys.setswitchinterval(interval)
    assert len(profiling._RECORD) == 2 * threads * reps
    for k in range(threads):
        units = unit_spans(f"stress.{k}", 2 * reps)
        assert len(units) == reps
        assert all([(s.name, s.parent) for s in u] ==
                   [(f"stress.{k}", None), (f"stress.{k}.child",
                                            f"stress.{k}")] for u in units)


def test_decorated_function_opens_a_span_a_call():
    @span("test.fn")
    def fn(depth):
        return fn(depth - 1) + 1 if depth else 0
    assert profiled_events(lambda: fn(2))[0] == 2
    (unit,) = unit_spans("test.fn", 3)
    assert [(s.name, s.parent) for s in unit] == [
        ("test.fn", None), ("test.fn", "test.fn"), ("test.fn", "test.fn")]


def test_step_is_the_same_with_the_profiler_on():
    off, on = Step(**CONFIGS["unimodal"]), Step(**CONFIGS["unimodal"])
    before = off.learned()
    for k, v in on.learned().items():
        assert torch.equal(v, before[k]), k
    got_off = off.run()
    got_on, _ = profiled_events(on.run)
    for k in ("p", "tv", "f"):
        assert torch.equal(got_off[k], got_on[k]), k
    after_off, after_on = off.learned(), on.learned()
    assert any(not torch.equal(after_off[k], before[k]) for k in before)
    for k, v in after_off.items():
        assert torch.equal(v, after_on[k]), k


def open_spans():
    """The names of the spans this thread has open."""
    return [s.name for s in getattr(profiling._LOCAL, "stack", [])]


def test_generator_top_holds_the_last_two_blocks():
    """One ``generator.top`` a generator pass, around both StyledConvs and
    the ToRGB of each of the last two synthesis blocks, and around no
    layer before them."""
    step = Step(**CONFIGS["unimodal"])
    g = step.generator
    layers = ([("conv1", g.conv1), ("to_rgb1", g.to_rgb1)] +
              [(f"convs.{i}", m) for i, m in enumerate(g.convs)] +
              [(f"to_rgbs.{i}", m) for i, m in enumerate(g.to_rgbs)])
    seen = []
    for name, m in layers:
        m.register_forward_pre_hook(
            lambda mod, args, name=name:
            seen.append((name, "generator.top" in open_spans())))

    def two_passes():
        with span("test.root"), torch.no_grad():
            g([step.z])
            g([step.z])
    profiled_events(two_passes)
    (unit,) = unit_spans("test.root", 1)
    assert [(s.name, s.parent) for s in unit] == [
        ("test.root", None), ("generator.top", "test.root"),
        ("generator.top", "test.root")]
    n = len(g.to_rgbs)
    top = {f"convs.{i}" for i in range(2 * n - 4, 2 * n)} | \
        {f"to_rgbs.{n - 2}", f"to_rgbs.{n - 1}"}
    assert len(top) == 6 and len(seen) == 2 * len(layers)
    assert collections.Counter(name for name, inside in seen if inside) \
        == {name: 2 for name in top}


class PlainSample:
    """A stand-in for the card's ``MipmapSample``: K1's plain version."""

    @staticmethod
    def apply(level0, coarse, shape, grid, levels, padding_mode):
        return tmipmap._sample_pyramid(
            tmipmap.Pyramid(level0, coarse, shape), grid, levels,
            padding_mode)


def warp_inputs():
    gen = torch.Generator().manual_seed(0)
    img = torch.rand(2, 3, 64, 64, generator=gen)
    grid = torch.rand(2, 16, 16, 2, generator=gen) * 2 - 1
    levels = tmipmap.jmax(tmipmap.mipmap_levels(grid, 64, 64, 3.5), 0.0)
    return img, grid, levels


def test_pyramid_opens_once_a_warp_on_the_card_path(monkeypatch):
    """The card's warp builds its pyramid inside one ``stn.pyramid``; the
    CPU's warp (the plain fold, which builds no pyramid) opens none. With
    the kernels' plain stand-in the card's path gives the CPU's image."""
    monkeypatch.setattr(tmipmap, "MipmapSample", PlainSample)
    img, grid, levels = warp_inputs()

    def warps():
        with span("test.root"):
            with span("stn.sample"):
                card = tmipmap._pyramid_warp(img, grid, 4, levels, "border")
            with span("stn.sample"):
                cpu = tmipmap.mipmap_warp(img, grid)
        return card, cpu
    (card, cpu), _ = profiled_events(warps)
    (unit,) = unit_spans("test.root", 1)
    assert collections.Counter(s.name for s in unit) == \
        {"test.root": 1, "stn.sample": 2, "stn.pyramid": 1}
    assert [s.parent for s in unit if s.name == "stn.pyramid"] == \
        ["stn.sample"]
    torch.testing.assert_close(card, cpu)


def test_new_spans_make_no_event_without_a_profiler(monkeypatch):
    """With no profiler on, a generator pass and the card's warp record no
    span and make no timing event: neither span adds a launch."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(FakeEvent, "made", 0)
    monkeypatch.setattr(tmipmap, "MipmapSample", PlainSample)
    step = Step(**CONFIGS["unimodal"])
    img, grid, levels = warp_inputs()
    with torch.no_grad():
        step.generator([step.z])
    tmipmap._pyramid_warp(img, grid, 4, levels, "border")
    assert FakeEvent.made == 0
    assert len(profiling._RECORD) == 0


# the benchmark's readers of the two spans: (root, stage) each
NEW_READERS = {"g_top_ms.train": ("train.step", "generator.top"),
               "pyramid_ms.train": ("train.step", "stn.pyramid"),
               "pyramid_ms.congeal": ("stn.composed", "stn.pyramid")}


@pytest.mark.parametrize("name", NEW_READERS)
def test_new_readers_read_nothing_without_their_spans(name, monkeypatch):
    """A program whose units hold the older stages but not this one (the
    program before these spans), or no stage spans at all, reads None;
    with the span, the median unit's sum."""
    from portbench import run
    root, stage = NEW_READERS[name]
    read = run.reader(name)
    older = [profiling.SpanTime(root, None, None),
             profiling.SpanTime("stn.sample", root, 3.0)]
    asked = []

    def spans_of(units):
        def unit_spans(r, n):
            asked.append(r)
            return [units] * n
        return unit_spans
    trace = types.SimpleNamespace(units=2)
    monkeypatch.setattr(profiling, "unit_spans", spans_of(older))
    assert read(trace) is None
    newer = older + [profiling.SpanTime(stage, "stn.sample", 1.5),
                     profiling.SpanTime(stage, "stn.sample", 2.0)]
    monkeypatch.setattr(profiling, "unit_spans", spans_of(newer))
    assert read(trace) == pytest.approx(3.5)
    assert asked == [root, root]
    monkeypatch.delattr(profiling, "unit_spans")
    assert read(trace) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_congeal_spans_stay_off_the_device_timeline(card):
    gen = torch.Generator().manual_seed(0)
    model = tstn.ComposedSTN(tstn.ComposedSTNConfig(**T), generator=gen)
    model = model.to(card).eval()
    images = torch.rand(4, 3, 64, 64, generator=gen).to(card)
    with torch.inference_mode():
        model(images)  # builds and warms the kernels
    torch.cuda.synchronize()
    activities = CPU + [torch.profiler.ProfilerActivity.CUDA]
    around = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with torch.profiler.profile(activities=activities) as prof:
        around[0].record()
        with torch.inference_mode():
            model(images)
        around[1].record()
        torch.cuda.synchronize()
    forward_ms = around[0].elapsed_time(around[1])
    names = {"stn.composed", "stn.features", "stn.sample"}
    on_device = [e for e in prof.profiler.kineto_results.events()
                 if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert on_device, "the trace holds the forward's kernels"
    assert not [e.name() for e in on_device if e.name() in names]
    (unit,) = unit_spans("stn.composed", 1)
    assert collections.Counter(s.name for s in unit) == \
        {"stn.composed": 1, "stn.features": 2, "stn.sample": 2,
         "stn.pyramid": 2}
    assert all(s.parent == "stn.sample" for s in unit
               if s.name == "stn.pyramid")
    assert unit[0].device_ms is None  # a root takes no events
    for s in unit[1:]:
        assert s.device_ms is not None and s.device_ms > 0, s
    assert sum(s.device_ms for s in unit[1:]) <= forward_ms * 1.001
