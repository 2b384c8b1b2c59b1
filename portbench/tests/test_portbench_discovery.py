"""The harness finds every cell's files by name, and a run prints the
result line the contract asks for."""

import copy
import json

import pytest
import torch

from portbench import run
from portbench.tests.conftest import RANKS, SEED, cell_files, tiny_files

BENCH = run.read_json(run.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_files_are_found_by_name(workload):
    cell, cfg, traffic, limits, e2e, layer = run.load_cell(workload)
    assert cell["name"] == workload
    assert hasattr(run.driver(traffic["kind"]), "build")
    assert limits and all(v > 0 for v in limits.values())
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert layer, "every cell reports a per-layer metric"
    for m in e2e + layer:
        assert callable(run.reader(m["name"]))
    for m in layer:
        assert m["moves"] in names


def test_per_layer_metrics_follow_their_end_to_end_metric():
    reported = {w: {m["name"] for m in run.load_cell(w)[4]} for w in CELLS}
    for m in BENCH["per_layer"]:
        for w in m["workloads"]:
            assert m["moves"] in reported[w], (m["name"], w)


# the keys that set a width; "published" states each configuration's
# source's, and no cut in "reduced" may name one
GENERATOR_WIDTHS = ("size", "style_dim", "channel_multiplier")
STN_WIDTHS = ("flow_size", "supersize", "channel_multiplier",
              "flow_downsample")
NOT_CUT = set(GENERATOR_WIDTHS + STN_WIDTHS) | {
    "generator", "stn", "max_channels", "published"}


def width_faults(cfg, reduced=()):
    """Where a configuration's widths depart from its ``published``
    block, or a cut (its file's ``reduced`` and ``reduced``) names a
    width: an empty list where they hold."""
    pub = cfg.get("published", {})
    faults = [f"published {k} lacks {w}"
              for k, widths in (("generator", GENERATOR_WIDTHS),
                                ("stn", STN_WIDTHS))
              for w in widths if w not in pub.get(k, {})]
    if cfg["generator"] != pub.get("generator"):
        faults.append("generator")
    faults += [f"stn.{k}" for k, v in pub.get("stn", {}).items()
               if cfg["stn"].get(k) != v]
    faults += [f"reduced {k}" for k in set(cfg.get("reduced", {})) |
               set(reduced) if k in NOT_CUT or k.endswith(("_dim", "_rank"))]
    return faults


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_configs_hold_their_published_widths(config):
    cfg = run.read_json(run.ROOT / config["file"])
    assert width_faults(cfg, config["reduced"]) == []


def test_configs_hold_the_recipes_widths():
    """The LSUN recipes' configurations as the benchmark first ran them."""
    for name in ("lsun_cats", "lsun_cars"):
        cfg = run.read_json(run.BENCH / "configs" / f"{name}.json")
        assert cfg["generator"] == {"size": 256, "style_dim": 512, "n_mlp": 8,
                                    "channel_multiplier": 2}
        assert cfg["stn"]["flow_size"] == 128
        assert cfg["stn"]["supersize"] == 256
        assert cfg["stn"]["channel_multiplier"] == 0.5


def config_f_1024():
    """A 1024 px StyleGAN2 config-f configuration (arXiv:1912.04958,
    Table 1, F) under the faces recipe, as a later configuration file
    would state it: no file of the benchmark is touched."""
    cfg = copy.deepcopy(run.load_cell("cats.train.b40")[1])
    cfg["name"] = "ffhq_config_f"
    cfg["generator"]["size"] = 1024
    cfg["published"]["generator"]["size"] = 1024
    cfg["latent_learner"].update(ndirs=512, inject=6)
    cfg["train"].update(loss_fn="lpips", tv_weight=2500.0,
                        sample_from_full_res=True)
    return cfg


def test_a_config_at_1024_fits_with_new_files_alone(capsys, two_threads):
    cfg = config_f_1024()
    assert width_faults(cfg, ["cold_start"]) == []
    files = list(run.load_cell("cats.train.b40"))
    files[1] = cfg
    tiny = tiny_files("cats.train.b40", files)
    args = run.parse(["--workload", "cats.train.b40", "--seed", str(SEED),
                      "--seconds", "0.2", "--trace", "0"])
    assert run.run(args, torch.device("cpu"), tiny) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "correct"] is True


@pytest.mark.parametrize("change", ["width", "cut", "unpublished"])
def test_widths_other_than_published_fail(change):
    cfg = config_f_1024()
    reduced = ["cold_start"]
    if change == "width":
        cfg["stn"]["channel_multiplier"] = 0.25
    elif change == "cut":
        reduced.append("style_dim")
    else:
        del cfg["published"]["stn"]["supersize"]
    assert width_faults(cfg, reduced) != []


@pytest.mark.parametrize("workload", CELLS + [RANKS])
def test_result_line(workload, capsys, two_threads):
    args = run.parse(["--workload", workload, "--seed", str(SEED),
                      "--seconds", "0.5", "--trace", "0"])
    assert run.run(args, torch.device("cpu"), tiny_files(workload)) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    assert line["attempted"] >= 1 and line["failed"] == 0
    for name, m in line["metrics"].items():
        assert m["value"] > 0 and m["unit"]
    assert set(line["checks"]) == set(cell_files(workload)[3])


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                     "1"]) != 0
    assert capsys.readouterr().out == ""


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import sys
    for name in list(sys.modules):
        if name.split(".")[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    monkeypatch.setitem(sys.modules, "gangealing_tpu_not", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax"]
