"""The port's eval CLIs (cli/pck.py, cli/flow_scores.py,
cli/congeal_dataset.py, cli/propagate_to_images.py) and run_pck on the CPU,
shaped like tests/test_cli_apps.py: run_pck against the JAX package's on
the same checkpoint (PCK values equal), each CLI with --device cpu against
the app functions it calls (equal results, its files written), and the
refusals of what later slices bring. The STN, the checkpoint and the
LMDBs are those of tests/test_torch_eval_apps.py.
"""

import argparse
import dataclasses
import os
from importlib import import_module

import numpy as np
import pytest
import torch

from gangealing_torch.apps import common as tcommon
from gangealing_torch.apps import congeal_dataset as tcong
from gangealing_torch.apps import flow_scores as tflow
from gangealing_torch.apps import pck as tpck
from gangealing_torch.cli import congeal_dataset as tcong_cli
from gangealing_torch.cli import flow_scores as tflow_cli
from gangealing_torch.cli import pck as tpck_cli
from gangealing_torch.cli import propagate_to_images as tprop_cli
from gangealing_torch.data import dataset as tds
from gangealing_torch.data.lmdb_io import LMDBReader

from test_torch_ar import ar_model, label_png
from test_torch_eval_apps import (  # noqa: F401 (fixtures)
    ALPHAS, ARCH, S, img_lmdb, model, params, pck_lmdbs, two_torch_threads,
    zoom_params)

jpck = import_module("gangealing_tpu.apps.pck")


def _checkpoint(tmp_path, model):
    os.makedirs(tmp_path, exist_ok=True)
    path = tmp_path / "stn.pt"
    args = argparse.Namespace(transform=list(ARCH["transforms"]),
                              flow_size=S, stn_channel_multiplier=0.25,
                              num_heads=1, real_size=S, flow_downsample=4)
    torch.save({"t_ema": model.state_dict(), "args": args}, path)
    return str(path)


@pytest.fixture
def capped(monkeypatch):
    """The stored args carry no channel cap; this architecture has one."""
    build = tcommon.stn_config_from_args
    monkeypatch.setattr(tcommon, "stn_config_from_args",
                        lambda a, supersize=None: dataclasses.replace(
                            build(a, supersize), max_channels=32))


def test_run_pck_and_cli_match_jax(tmp_path, model, pck_lmdbs, capped):
    """run_pck from a checkpoint on the CPU against the JAX package's
    run_pck; the CLI (--num_bootstrap, --vis_transfer) equal to run_pck,
    with finite bootstrap deviations and the transfer grid written."""
    ckpt = _checkpoint(tmp_path, model)
    path = pck_lmdbs["spair"]
    kw = dict(alphas=ALPHAS, real_size=S, batch=3, transfer_both_ways=True)
    ours = tpck.run_pck(ckpt, path, device="cpu", **kw)
    ref = jpck.run_pck(ckpt, path, mesh=None, **kw)
    np.testing.assert_array_equal(ours, ref)
    out = str(tmp_path / "vis")
    pck, std = tpck_cli.main([
        "--ckpt", ckpt, "--real_data_path", path, "--real_size", str(S),
        "--batch", "3", "--transfer_both_ways", "--num_bootstrap", "2",
        "--vis_transfer", "--out", out, "--device", "cpu"])
    np.testing.assert_array_equal(pck, ours)
    assert std.shape == (3,) and np.isfinite(std).all()
    assert os.path.getsize(os.path.join(out, "transfers",
                                        "transfer_grid.png")) > 0


def test_eval_clis_on_the_cpu(tmp_path, model, zoom_params, img_lmdb,
                              capped):
    """cli.flow_scores, cli.congeal_dataset and cli.propagate_to_images
    (with --flow_scores) with --device cpu: the results of the app
    functions on the same inputs, and their files written."""
    import shutil
    from gangealing_torch.apps.propagate_to_images import propagate_to_images
    ckpt = _checkpoint(tmp_path, model)
    data = str(tmp_path / "data")
    shutil.copytree(img_lmdb, data)
    base = ["--ckpt", ckpt, "--real_data_path", data, "--real_size",
            str(S), "--batch", "4", "--device", "cpu"]
    scores = tflow_cli.main(base)
    np.testing.assert_array_equal(scores, tflow.compute_flow_scores(
        model, data, real_size=S, batch=4, save=False, device="cpu"))
    cache = os.path.join(data, "flow_scores.pt")
    assert os.path.getsize(cache) > 0
    # congeal_dataset with the zoomed similarity head, whose warps stay
    # in the images
    zoom = ar_model(zoom_params)
    zoom_ckpt = _checkpoint(tmp_path / "zoom", zoom)
    out = str(tmp_path / "aligned")
    used = tcong_cli.main(base[2:] + [
        "--ckpt", zoom_ckpt, "--out", out, "--flow_size", str(S),
        "--output_resolution", "32", "--min_effective_resolution", "0",
        "--flow_scores", cache, "--fraction_retained", "0.5"])
    assert used == tcong.align_and_filter_dataset(
        zoom, data, str(tmp_path / "app"), real_size=S, flow_size=S,
        output_resolution=32, batch=4, min_effective_resolution=0,
        flow_scores_path=cache, fraction_retained=0.5, device="cpu")
    assert 0 < len(used) <= len(tflow.get_high_score_indices(scores, 0.5))
    assert LMDBReader(out).get(b"length") == str(len(used)).encode()
    label = label_png(tmp_path / "label.png")
    vis = str(tmp_path / "vis")
    got = tprop_cli.main(base + ["--out", vis, "--label_path", label,
                                 "--objects", "--flow_scores", cache,
                                 "--fraction_retained", "0.5",
                                 "--n_images", "3", "--resolution", str(S),
                                 "--save_individual_images"])
    kept = tflow.filter_dataset(tds.MultiResolutionDataset(data, S), cache,
                                0.5)
    want = propagate_to_images(model, np.stack([kept[i] for i in range(3)]),
                               label_path=label, sigma=1.3, opacity=0.75,
                               batch=4, objects=True, resolution=S,
                               average_n=0)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    for name in ("congealed.png", "propagated.png",
                 os.path.join("propagated", "00002.png")):
        assert os.path.getsize(os.path.join(vis, name)) > 0


@pytest.mark.parametrize("cli", [tpck_cli, tflow_cli, tcong_cli, tprop_cli])
def test_eval_clis_refuse_later_slices_and_default_to_the_card(
        tmp_path, model, capped, cli, capsys, monkeypatch):
    argv = ["--ckpt", _checkpoint(tmp_path, model), "--real_data_path",
            str(tmp_path)]
    if cli is tcong_cli:
        argv += ["--out", str(tmp_path / "o")]
    with pytest.raises(SystemExit):
        cli.main(argv + ["--num_devices", "2"])
    assert "multi-GPU slice" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # --num_heads: refused where the JAX CLI refuses it, for its reason;
    # not read by the others, which go on to the device
    refused = {tflow_cli: "flow_scores", tcong_cli: "congealing"}.get(cli)
    if refused is not None:
        with pytest.raises(SystemExit):
            cli.main(argv + ["--num_heads", "2"])
        assert f"clustering not supported for {refused}" in \
            capsys.readouterr().err
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv + ["--num_heads", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)


def test_eval_apps_default_to_the_card(tmp_path, model, capped,
                                       monkeypatch):
    ckpt = _checkpoint(tmp_path, model)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tflow.compute_flow_scores(model, str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcong.align_and_filter_dataset(model, str(tmp_path),
                                       str(tmp_path / "o"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpck.run_pck(ckpt, str(tmp_path))
