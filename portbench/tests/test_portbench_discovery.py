"""The harness finds every cell's files by name, and a run prints the
result line the contract asks for."""

import json

import pytest
import torch

from portbench import run
from portbench.tests.conftest import SEED, tiny_files

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


def test_configs_hold_the_recipes_widths():
    for c in BENCH["configs"]:
        cfg = run.read_json(run.ROOT / c["file"])
        assert cfg["generator"] == {"size": 256, "style_dim": 512, "n_mlp": 8,
                                    "channel_multiplier": 2}
        assert cfg["stn"]["flow_size"] == 128
        assert cfg["stn"]["supersize"] == 256
        assert cfg["stn"]["channel_multiplier"] == 0.5


@pytest.mark.parametrize("workload", CELLS)
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
    assert set(line["checks"]) == set(run.load_cell(workload)[3])


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
