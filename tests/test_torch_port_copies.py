"""The port's own copies of the JAX package's framework-free helpers held
against their originals on the same inputs: the schedules value for value
over a range of iterations, the parsers' flags and defaults, the key
orders, the checkpoint reader and the checkpoint helpers; and the port's
copy of matplotlib's colormap tables against matplotlib."""

import argparse
import os
from importlib import import_module

import numpy as np
import pytest
import torch

from gangealing_torch.cli import args as targs
from gangealing_torch.cli import mixed_reality as tmr_cli
from gangealing_torch.cli import train as ttrain_cli
from gangealing_torch.io import torch_import as tio
from gangealing_torch.train import annealing as tann
from gangealing_torch.train import checkpoint as tckpt
from gangealing_torch.utils import download as tdl

jargs = import_module("gangealing_tpu.cli.args")
jio = import_module("gangealing_tpu.io.torch_import")
jann = import_module("gangealing_tpu.train.annealing")
jckpt = import_module("gangealing_tpu.train.checkpoint")
jdl = import_module("gangealing_tpu.utils.download")

ITERS = list(range(0, 60)) + [99, 100, 101, 149, 150, 151, 1000, 12345]


@pytest.mark.parametrize("anneal_fn", ["cosine", "linear"])
def test_psi_schedule_matches_jax(anneal_fn):
    for anneal_psi in (0, 1, 50, 150):
        assert [tann.psi_at_iter(i, anneal_psi, anneal_fn) for i in ITERS] \
            == [jann.psi_at_iter(i, anneal_psi, anneal_fn) for i in ITERS]
    assert [tann.fastslow_anneal(i, 1.0, 0.0, 40) for i in range(40)] == \
        [jann.fastslow_anneal(i, 1.0, 0.0, 40) for i in range(40)]


@pytest.mark.parametrize("fn", ["lr_at_iter", "lr_used_at_iter"])
@pytest.mark.parametrize("tm,decay", [(1, 0.9), (2, 0.9), (3, 0.5)])
def test_lr_schedule_matches_jax(fn, tm, decay):
    for anneal_psi, period in ((50, 7.0), (0, 3.0), (150, 37500.0)):
        kw = dict(t_mult=tm, decay=decay)
        assert [getattr(tann, fn)(i, 1e-3, anneal_psi, period, **kw)
                for i in ITERS] == \
            [getattr(jann, fn)(i, 1e-3, anneal_psi, period, **kw)
             for i in ITERS]


def test_warm_restarts_and_cycles_match_jax():
    epochs = np.linspace(0, 40, 401).tolist()
    for tm in (1, 2, 3):
        assert [tann.decaying_cosine_warm_restarts(e, 0.01, t_mult=tm)
                for e in epochs] == \
            [jann.decaying_cosine_warm_restarts(e, 0.01, t_mult=tm)
             for e in epochs]
    for args in ((150, 37500, 800000, 2), (10, 5, 1000, 3), (10, 5, 12, 2),
                 (10, 5, 1000, 1)):
        assert tann.lr_cycle_iters(*args) == jann.lr_cycle_iters(*args)


def _flags(parser):
    return {a.dest: (a.default, a.choices, a.nargs, a.type, a.required,
                     a.option_strings)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("name", ["base_training_argparse",
                                  "base_eval_argparse"])
def test_parsers_match_jax(name):
    ours, ref = getattr(targs, name)(), getattr(jargs, name)()
    assert _flags(ours) == _flags(ref)
    argv = ["--ckpt", "x.pt"]
    if name == "base_training_argparse":
        argv += ["--exp-name", "e", "--transform", "flow", "--batch", "3"]
    assert vars(ours.parse_args(argv)) == vars(ref.parse_args(argv))


def test_cli_parsers_add_only_device():
    """The CLIs take the JAX package's flags plus --device (default
    cuda)."""
    train = _flags(ttrain_cli.training_argparse())
    assert set(train) - set(_flags(jargs.base_training_argparse())) == \
        {"device"}
    assert train["device"][0] == "cuda"
    mr =_flags(tmr_cli.mixed_reality_argparse())
    assert set(mr) - set(_flags(jargs.base_eval_argparse())) == {
        "video_path", "label_path", "out", "sigma", "opacity", "blend_alg",
        "objects", "save_correspondences", "resolution", "cluster", "fps",
        "max_frames", "save_frames", "average_path", "overlay_congealed",
        "device"}
    assert mr["device"][0] == "cuda"


def _state_dict():
    g = torch.Generator().manual_seed(0)
    keys = ["stns.0.convs.0.0.weight", "stns.0.convs.1.conv2.0.kernel",
            "noises.noise_0", "directions", "lat_mean", "coefficients",
            "input.input_buffer", "stns.1.warp_head.one_hot",
            "skip.0.kernel", "convs.0.blur.kernel", "to_rgbs.0.upsample.kernel",
            "stns.1.warp_head.flow_out.0.weight", "style.1.bias"]
    return {k: torch.randn(3, 2, generator=g) for k in keys}


def test_key_order_and_state_dict_import_match_jax():
    sd = _state_dict()
    assert tio.learnable_key_order(sd) == jio.learnable_key_order(sd)
    assert [tio._should_drop(k) for k in sd] == \
        [jio._should_drop(k) for k in sd]
    ours, ref = tio.import_state_dict(sd), jio.import_state_dict(sd)
    assert list(ours) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])
        assert ours[k].dtype == ref[k].dtype


def test_load_torch_checkpoint_matches_jax(tmp_path):
    sd = _state_dict()
    path = str(tmp_path / "c.pt")
    torch.save({"t_ema": sd, "g_ema": sd, "t_optim": {"state": {}},
                "args": argparse.Namespace(flow_size=64, num_heads=1)}, path)
    ours, ref = tio.load_torch_checkpoint(path), jio.load_torch_checkpoint(path)
    assert set(ours) == set(ref)
    assert ours["args"] == ref["args"]
    for name in ("t_ema", "g_ema"):
        assert list(ours[name]) == list(ref[name])
        for k in ref[name]:
            np.testing.assert_array_equal(ours[name][k], ref[name][k])
    assert set(ours["_raw"]) == set(ref["_raw"])


@pytest.mark.parametrize("tm", [1, 2, 3])
def test_sched_state_matches_jax(tm):
    for i in ITERS:
        assert tckpt._export_sched_state(1e-3, i, 50, 7.0, tm, 0.9) == \
            jckpt._export_sched_state(1e-3, i, 50, 7.0, tm, 0.9)


def test_checkpoint_discovery_matches_jax(tmp_path):
    results = tmp_path / "results"
    assert tckpt.latest_checkpoint(str(results)) is None
    assert jckpt.latest_checkpoint(str(results)) is None
    (results / "checkpoints").mkdir(parents=True)
    for name in ("0000002.pt", "0000010.pt", "best_0000050.pt", "x.pt",
                 "0000007.pt"):
        (results / "checkpoints" / name).write_bytes(b"")
    assert tckpt.latest_checkpoint(str(results)) == \
        jckpt.latest_checkpoint(str(results))
    for name in ("a/0000123.pt", "best_0000050.pt", "g.pt", "12.pth", "7"):
        assert tckpt.parse_start_iter(name) == jckpt.parse_start_iter(name)


def test_model_zoo_matches_jax(tmp_path, monkeypatch):
    assert tdl.PRETRAINED_TEST_HYPERPARAMS == jdl.PRETRAINED_TEST_HYPERPARAMS
    assert tdl.VALID_MODELS == jdl.VALID_MODELS
    monkeypatch.chdir(tmp_path)
    os.makedirs("pretrained")
    open(os.path.join("pretrained", "cat.pt"), "wb").close()
    open("local.pt", "wb").close()
    for name in ("cat", "local.pt"):
        assert tdl.find_model(name) == jdl.find_model(name)
    for name in ("dog", "no/such.pt"):
        with pytest.raises(FileNotFoundError) as ours:
            tdl.find_model(name)
        with pytest.raises(FileNotFoundError) as ref:
            jdl.find_model(name)
        assert str(ours.value) == str(ref.value)


def test_native_lmdb_source_is_a_byte_copy():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "native", "lmdb_kv.cc"), "rb") as f:
        ref = f.read()
    with open(os.path.join(repo, "gangealing_torch", "native",
                           "lmdb_kv.cc"), "rb") as f:
        assert f.read() == ref


def test_build_shared_lib_matches_jax(tmp_path):
    """Both build a missing library, leave a newer one alone, rebuild one
    older than a source, and on a compile error raise and leave neither a
    library nor a temp file."""
    import subprocess
    from gangealing_torch.data import _native_build as tbuild
    jbuild = import_module("gangealing_tpu.data._native_build")
    for name, mod in (("ours", tbuild), ("ref", jbuild)):
        src = tmp_path / f"{name}_x.cc"
        src.write_text('extern "C" int gt_x() { return 7; }\n')
        so = str(tmp_path / name / "b" / "libx.so")
        assert mod.build_shared_lib([str(src)], so) == so
        first = os.path.getmtime(so)
        os.utime(so, (first + 10, first + 10))
        mod.build_shared_lib([str(src)], so)
        assert os.path.getmtime(so) == first + 10  # newer: not rebuilt
        os.utime(str(src), (first + 20, first + 20))
        mod.build_shared_lib([str(src)], so)
        assert os.path.getmtime(so) != first + 10  # older: rebuilt
        import ctypes
        assert ctypes.CDLL(so).gt_x() == 7
        bad = tmp_path / f"{name}_bad.cc"
        bad.write_text("this is not C++\n")
        bad_so = str(tmp_path / name / "bad" / "libbad.so")
        with pytest.raises(subprocess.CalledProcessError):
            mod.build_shared_lib([str(bad)], bad_so)
        assert os.listdir(os.path.dirname(bad_so)) == []


class _Parsed(Exception):
    pass


def _jax_cli_parser(module, monkeypatch):
    """The parser a JAX package CLI builds inside its main()."""
    def capture(self, *a, **kw):
        raise _Parsed(self)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed) as e:
        import_module(f"gangealing_tpu.cli.{module}").main()
    monkeypatch.undo()
    return e.value.args[0]


@pytest.mark.parametrize("module,argv", [
    ("pck", ["--ckpt", "s.pt"]),
    ("flow_scores", ["--ckpt", "s.pt"]),
    ("congeal_dataset", ["--ckpt", "s.pt", "--out", "o"]),
    ("propagate_to_images", ["--ckpt", "s.pt", "-s", "2", "-o", "0.5"]),
    ("prepare_data", ["--out", "o", "--path", "p", "--n_worker", "3"]),
    ("train_cluster_classifier", ["--exp-name", "e", "--ckpt", "c.pt",
                                  "--num_heads", "4", "--flips"]),
    ("vis_correspondence", ["--ckpt", "s.pt", "--num_frames", "7",
                            "--mode", "average", "--dset_indices", "1",
                            "5"]),
    ("process_video", ["--video", "v.mp4", "--out", "o", "--size",
                       "128,256", "--pad", "zero"])])
def test_eval_cli_parsers_match_jax(module, argv, monkeypatch):
    """The eval CLIs take the JAX package's flags, defaults and choices
    and --device (default cuda); the dataset CLIs, which run on the
    host, take exactly the JAX package's."""
    ref = _jax_cli_parser(module, monkeypatch)
    ours = getattr(import_module(f"gangealing_torch.cli.{module}"),
                   f"{module}_argparse")()
    flags, ref_flags = _flags(ours), _flags(ref)
    parsed, ref_parsed = vars(ours.parse_args(argv)), vars(
        ref.parse_args(argv))
    if module in ("prepare_data", "process_video"):
        assert flags == ref_flags and parsed == ref_parsed
        return
    assert set(flags) - set(ref_flags) == {"device"}
    assert flags["device"][0] == "cuda"
    assert {k: v for k, v in flags.items() if k != "device"} == ref_flags
    assert parsed.pop("device") == "cuda"
    assert parsed == ref_parsed


def test_colormap_tables_are_matplotlibs():
    """The colormaps the apps splat with ('turbo' and the cluster
    colorscales) are matplotlib's 256-entry tables in float32, and
    get_colors samples them as matplotlib does, for any number of points."""
    import matplotlib
    from gangealing_torch.utils import vis as tvis
    jvis = import_module("gangealing_tpu.utils.vis")
    with np.load(tvis._COLORMAPS) as tables:
        names = set(tables.files)
        for name in names:
            lut = matplotlib.colormaps[name](np.arange(256))[:, :3]
            np.testing.assert_array_equal(tables[name],
                                          lut.astype(np.float32))
    used = {tvis._MPL_FALLBACKS.get(c, c)
            for c in tvis.CLUSTER_COLORSCALES + ["turbo"]}
    assert used <= names
    for scale in tvis.CLUSTER_COLORSCALES + ["turbo"]:
        for n in (1, 2, 7, 255, 256, 257, 4060):
            np.testing.assert_array_equal(
                tvis.get_colors(n, scale).numpy(),
                np.asarray(jvis.get_colors(n, scale)), f"{scale} {n}")
