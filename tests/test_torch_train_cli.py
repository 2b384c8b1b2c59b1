"""``python -m gangealing_torch.cli.train`` on the CPU at a small size: a
few iterations from a generator checkpoint in the reference schema, with
the PCA cold start (``--debug``: 1000 latents), finite scalars, a
checkpoint at ``--ckpt_every``, and ``--auto_resume`` picking it up; the
training visuals and the profiler window write their files; a bfloat16
run trains and checkpoints; the clustering options give the JAX CLI's
configuration. Blocks of steps (``--scan_k``) are tested in
tests/test_torch_scan.py."""

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


def _generator_checkpoint(tmp):
    args = tcli.training_argparse().parse_args(_argv(tmp, 2))
    g = tg.Generator(tcli.build_configs(args).g,
                     generator=torch.Generator().manual_seed(0))
    torch.save({"g_ema": g.state_dict()}, tmp / "g.pt")


def _real_lmdb(tmp):
    """3 real images of 64 px in an LMDB."""
    import io
    import numpy as np
    from PIL import Image
    from gangealing_torch.data.lmdb_io import write_lmdb
    items = {b"length": b"3"}
    rng = np.random.RandomState(0)
    for i in range(3):
        buf = io.BytesIO()
        Image.fromarray(rng.randint(0, 255, (64, 64, 3)).astype(
            np.uint8)).save(buf, format="png")
        items[f"64-{str(i).zfill(5)}".encode()] = buf.getvalue()
    write_lmdb(str(tmp / "reals"), items)
    return str(tmp / "reals")


def test_cli_train_and_auto_resume(tmp_path, small_widths):
    _generator_checkpoint(tmp_path)

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
    (["--vis_every", "5"], "visuals"),
    (["--compute_dtype", "bfloat16"], "precision"),
    (["--profile_dir", "p"], "profiling")])
def test_cli_refuses_later_slices(tmp_path, small_widths, extra, slice_name):
    """The options that later slices ported are taken. The clustering
    options give the JAX CLI's configuration
    (tests/test_torch_cluster_apps.py trains with them). So are the
    visuals and the profiler window: a run of 2 iterations draws its
    grids at 0 and 1 (the zero of the learning rate) and at 2
    (``--vis_every 2``), the congealed reals from ``--real_data_path``;
    ``--profile_dir`` writes a Chrome trace of its window (1, 2]. So is
    ``--compute_dtype bfloat16``: 2 iterations log finite scalars and
    write a checkpoint that loads, with float32 parameters."""
    if slice_name == "precision":
        _generator_checkpoint(tmp_path)
        state, _, _, _ = tcli.main(_argv(tmp_path, 2, *extra))
        assert state.cfg.compute_dtype == "bfloat16"
        scalars = _scalars(tmp_path)
        assert {s["step"] for s in scalars} == {1, 2}
        assert all(math.isfinite(s["value"]) for s in scalars)
        ckpt = tckpt.load_checkpoint(
            tmp_path / "results" / "smoke" / "checkpoints" / "0000002.pt")
        assert ckpt["args"].compute_dtype == "bfloat16"
        t = tcli.ComposedSTN(state.cfg.t)
        t.load_state_dict(tckpt.module_state(ckpt["t"]), strict=True)
        assert all(v.dtype == torch.float32 for v in ckpt["t"].values())
        return
    if slice_name in ("visuals", "profiling"):
        _generator_checkpoint(tmp_path)
        if slice_name == "visuals":
            extra = ["--vis_every", "2", "--real_data_path",
                     _real_lmdb(tmp_path), "--n_sample", "2",
                     "--vis_batch_size", "2"]
        else:
            extra = ["--profile_dir", str(tmp_path / "p"),
                     "--profile_start", "1", "--profile_stop", "2"]
        tcli.main(_argv(tmp_path, 2, *extra))
        run = os.listdir(tmp_path / "results" / "smoke")
        if slice_name == "profiling":
            traces = os.listdir(tmp_path / "p")
            assert len(traces) == 1 and traces[0].endswith(".json")
            assert not any(f.endswith(".png") for f in run)
            return
        for name in ("sample", "transformed_sample", "truncated_sample",
                     "mean_transformed_sample",
                     "EMA_transformed_real_sample",
                     "mean_EMA_transformed_real_sample", "flow_real"):
            assert {f"{name}_{str(i).zfill(7)}.png" for i in range(3)} <= \
                set(run), name
        return
    if slice_name == "cluster":
        from importlib import import_module
        jtrain = import_module("gangealing_tpu.cli.train")
        jargs = import_module("gangealing_tpu.cli.args")
        parser = tcli.training_argparse()
        args = parser.parse_args(_argv(tmp_path, 2, *extra))
        tcli.check_supported(parser, args)
        argv = _argv(tmp_path, 2, *extra)
        del argv[argv.index("--device"):argv.index("--device") + 2]
        jcfg = jtrain.build_configs(
            jargs.base_training_argparse().parse_args(argv))
        cfg = tcli.build_configs(args)
        assert (cfg.t.num_heads, cfg.ll.num_heads, cfg.flips) == (
            jcfg.t.num_heads, jcfg.ll.num_heads, jcfg.flips)
        assert cfg.t.num_heads > 1 or cfg.flips


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
