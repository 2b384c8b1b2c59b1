"""``python -m gangealing_torch.cli.train`` on the CPU at a small size: a
few iterations from a generator checkpoint in the reference schema, with
the PCA cold start (``--debug``: 1000 latents), finite scalars, a
checkpoint at ``--ckpt_every``, and ``--auto_resume`` picking it up; the
options of later slices are refused with the slice's name."""

import dataclasses
import json
import math
import os

import pytest
import torch

from gangealing_torch.cli import train as tcli
from gangealing_torch.models import stylegan2 as tg
from gangealing_torch.train import checkpoint as tckpt

from test_torch_train_common import two_torch_threads  # noqa: F401


def _argv(tmp, iters, *extra):
    return ["--exp-name", "smoke", "--results", str(tmp / "results"),
            "--ckpt", str(tmp / "g.pt"), "--load_G_only",
            "--gen_size", "64", "--real_size", "64", "--flow_size", "64",
            "--dim_latent", "32", "--n_mlp", "2", "--batch", "2",
            "--iter", str(iters), "--anneal_psi", "2", "--period", "1",
            "--ndirs", "2", "--inject", "3", "--debug", "--log_every", "1",
            "--ckpt_every", "2", "--vis_every", "0", "--padding_mode",
            "border", "--stn_channel_multiplier", "0.25", "--device", "cpu",
            *extra]


def _scalars(tmp):
    with open(tmp / "results" / "smoke" / "scalars.jsonl") as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.fixture
def small_widths(monkeypatch):
    """The flags carry no channel cap; this small test architecture has
    one (32 channels), as the JAX package's small tests do."""
    build = tcli.build_configs

    def capped(args):
        cfg = build(args)
        return dataclasses.replace(
            cfg, g=dataclasses.replace(cfg.g, max_channels=32),
            t=dataclasses.replace(cfg.t, max_channels=32))
    monkeypatch.setattr(tcli, "build_configs", capped)


def test_cli_train_and_auto_resume(tmp_path, small_widths):
    args = tcli.training_argparse().parse_args(_argv(tmp_path, 2))
    g = tg.Generator(tcli.build_configs(args).g,
                     generator=torch.Generator().manual_seed(0))
    torch.save({"g_ema": g.state_dict()}, tmp_path / "g.pt")

    state, _, _, _ = tcli.main(_argv(tmp_path, 2))
    first = _scalars(tmp_path)
    assert {s["step"] for s in first} == {1, 2}
    assert all(math.isfinite(s["value"]) for s in first)
    names = {s["name"] for s in first}
    assert {"Loss/Reconstruction", "Loss/TotalVariation",
            "Progress/psi"} <= names
    ckpt_dir = tmp_path / "results" / "smoke" / "checkpoints"
    assert "0000002.pt" in os.listdir(ckpt_dir)
    ckpt = tckpt.load_checkpoint(ckpt_dir / "0000002.pt")
    assert set(ckpt) == {"g_ema", "t", "t_ema", "ll", "t_optim", "ll_optim",
                         "t_sched", "ll_sched", "args"}
    # the cold start replaced the random directions with unit PCA ones
    assert torch.allclose(state.ll.directions.norm(dim=1), torch.ones(2))

    state, _, _, _ = tcli.main(_argv(tmp_path, 3, "--auto_resume"))
    resumed = [s for s in _scalars(tmp_path)[len(first):]]
    assert {s["step"] for s in resumed} == {3}
    assert all(math.isfinite(s["value"]) for s in resumed)
    assert int(state.t_optim.state_dict()["state"][0]["step"]) == 3
    assert "0000003.pt" not in os.listdir(ckpt_dir)


@pytest.mark.parametrize("extra,slice_name", [
    (["--num_heads", "2"], "cluster"), (["--flips"], "cluster"),
    (["--vis_every", "5"], "visuals"), (["--scan_k", "4"], "performance"),
    (["--compute_dtype", "bfloat16"], "precision"),
    (["--profile_dir", "p"], "profiling")])
def test_cli_refuses_later_slices(tmp_path, capsys, extra, slice_name):
    with pytest.raises(SystemExit):
        tcli.main(_argv(tmp_path, 2, *extra))
    assert slice_name in capsys.readouterr().err


@pytest.mark.parametrize("prefix", ["features.", "module."])
def test_cli_perceptual_weights_load_or_raise(tmp_path, prefix):
    """A torchvision VGG16 ``features.N`` state_dict loads into every
    ``net.*`` weight, exactly; one saved under another prefix, which the
    importer cannot map, raises instead of training a random VGG."""
    src = tcli.LPIPS(generator=torch.Generator().manual_seed(1))
    sd = {prefix + k.split(".", 1)[1]: v
          for k, v in src.net.state_dict().items()}
    torch.save(sd, tmp_path / "vgg.pt")
    args = tcli.training_argparse().parse_args(
        _argv(tmp_path, 2, "--perceptual_weights", str(tmp_path / "vgg.pt")))
    if prefix == "module.":
        with pytest.raises(ValueError, match="missing"):
            tcli.load_perceptual(args, "cpu", torch.Generator())
        return
    model, _ = tcli.load_perceptual(args, "cpu", torch.Generator())
    for k, v in src.net.state_dict().items():
        assert torch.equal(model.net.state_dict()[k], v), k


def test_cli_train_needs_a_card_unless_asked(tmp_path, monkeypatch):
    """--device defaults to cuda; with no card visible the run raises
    instead of training on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcli.training_argparse().parse_args(
        ["--exp-name", "x", "--ckpt", "g.pt"]).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(_argv(tmp_path, 2, "--device", "cuda"))
