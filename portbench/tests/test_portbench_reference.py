"""The plain reference against the port's CPU path at a tiny size, on the
benchmark's seeded weights."""

import copy

import pytest
import torch

from gangealing_torch.models.lpips import LPIPS, make_perceptual_loss
from gangealing_torch.models.stn import ComposedSTN as PortSTN
from gangealing_torch.models.stylegan2 import Generator as PortG

from portbench import run
from portbench.drivers import train as train_driver
from portbench.reference import lpips as ref_lpips
from portbench.reference.train import build_modules, model_configs
from portbench.tests.conftest import SEED, tiny_files


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_files("cars.train.b20")[1]
    states = train_driver.seeded_states(cfg, SEED, torch.device("cpu"))
    return cfg, states


def test_weights_are_the_seeds(tiny):
    cfg, states = tiny
    again = train_driver.seeded_states(cfg, SEED, torch.device("cpu"))
    other = train_driver.seeded_states(cfg, SEED + 1, torch.device("cpu"))
    for name in states:
        for k in states[name]:
            assert torch.equal(states[name][k], again[name][k])
        assert any(not torch.equal(states[name][k], other[name][k])
                   for k in states[name])
    # no leaf left at a constant: every path of the forward is exercised
    for name in ("g", "t", "lpips"):
        for k, v in states[name].items():
            assert v.numel() == 1 or float(v.std()) > 0, (name, k)


def test_generator_matches(tiny, two_threads):
    cfg, states = tiny
    g_cfg, _, _ = model_configs(cfg)
    ref = build_modules(cfg, "cpu")["g"]
    ref.load_state_dict(states["g"])
    port = PortG(train_driver.program_config(cfg, 2, "float32").g)
    port.load_state_dict(states["g"])
    z = torch.randn(2, g_cfg.style_dim, generator=torch.Generator()
                    .manual_seed(1))
    noise = [torch.randn(s) for s in g_cfg.noise_shapes(2)]
    with torch.no_grad():
        assert torch.equal(ref([z], noise=noise)[0], port([z], noise=noise)[0])


def test_stn_matches(tiny, two_threads):
    cfg, states = tiny
    ref = build_modules(cfg, "cpu")["t"]
    ref.load_state_dict(states["t"])
    port = PortSTN(train_driver.program_config(cfg, 2, "float32").t)
    port.load_state_dict(states["t"])
    x = torch.tanh(torch.randn(2, 3, 64, 64))
    with torch.no_grad():
        for a, b in zip(ref(x)[:3], port(x)[:3]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["vgg_ssl", "lpips"])
def test_perceptual_matches(tiny, kind, two_threads):
    cfg, states = tiny
    cfg = copy.deepcopy(cfg)
    cfg["train"]["loss_fn"] = kind
    st = train_driver.seeded_states(cfg, SEED, torch.device("cpu"))["lpips"]
    ref = build_modules(cfg, "cpu")["lpips"]
    ref.load_state_dict(st)
    port = LPIPS(use_lins=kind == "lpips")
    port.load_state_dict(st)
    x, y = torch.tanh(torch.randn(2, 2, 3, 32, 32))
    with torch.no_grad():
        assert torch.equal(ref_lpips.make_perceptual_loss(kind)(ref, x, y),
                           make_perceptual_loss(kind)(port, x, y))


@pytest.mark.parametrize("workload", ["cats.train.b40", "cars.train.b20"])
def test_train_steps_match(workload, two_threads):
    _, cfg, traffic, limits, _, _ = tiny_files(workload)
    cell = train_driver.build(cfg, traffic, SEED, torch.device("cpu"), {})
    for _ in range(2):  # the window
        cell.run_unit()
    cell.release()
    numbers, _, counters = cell.check(list(train_driver.COMPARED),
                                      count=True)
    assert numbers["loss_gap"] == 0.0
    assert numbers["p_gap"] == 0.0
    assert numbers["change_gap"] == 0.0
    assert numbers["grad_gap"] < 1e-6  # Adam's first moment, read back
    assert counters["model_flops_per_unit"] > 0
    assert 0 < counters["k1_least_s"] and 0 < counters["k3_least_s"]


def test_state_is_reset_for_the_pass_after_the_window(two_threads):
    _, cfg, traffic, _, _, _ = tiny_files("cars.train.b20")
    cell = train_driver.build(cfg, traffic, SEED, torch.device("cpu"), {})
    for _ in range(2):
        cell.run_unit()
    cell.release()
    (terms_a, grads_a, after_a), (terms_b, grads_b, after_b) = cell.passes
    assert terms_a == terms_b
    for k in grads_a:
        assert torch.equal(grads_a[k], grads_b[k]), k
    for k in after_a:
        assert torch.equal(after_a[k], after_b[k]), k
