"""Each cell once on the card, short, through the command the driver runs:
exit 0, a correct result line from the card. Run on the card with
``python -m pytest -m cuda portbench/tests``. A cell that asks for more
cards than are visible is skipped, with the reason, so that a box with one
card runs the others."""

import json
import subprocess
import sys

import pytest
import torch

from portbench import run
from portbench.tests.conftest import RANKS, cell_files

CELLS = [w["name"] for w in run.read_json(run.ROOT / "BENCHMARK.json")
         ["workloads"]]


def enough_cards(workload, chips):
    """Skip unless ``chips`` cards, as many as ``workload`` asks for, are
    visible."""
    visible = torch.cuda.device_count()
    if visible < chips:
        pytest.skip(f"{workload} needs {chips} cards; {visible} visible")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(workload, card):
    chips = run.load_cell(workload)[0]["chips"]
    enough_cards(workload, chips)
    proc = subprocess.run(
        [sys.executable, str(run.BENCH / "run.py"), "--workload", workload,
         "--seed", str(2 ** 31 + 77), "--seconds", "2", "--trace", "0"],
        cwd=run.ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["count"] == chips


@pytest.mark.cuda
def test_ranks_cell_at_world_one_over_nccl(card):
    """The data-parallel cell on one card, a world of one over NCCL, at
    the global batch of 40: the all-reduce runs and the check holds."""
    from portbench import calibrate
    cell, cfg, traffic, *rest = cell_files(RANKS)
    batch = traffic["world"] * traffic["batch"]
    files = (dict(cell, chips=1), cfg,
             dict(traffic, world=1, batch=batch),
             *rest)
    line = calibrate.reading(RANKS, 2 ** 31 + 79, card, cell_files=files)
    assert line["correct"], line["checks"]
    assert line["device"]["count"] == 1


def test_a_cell_over_more_cards_than_visible_is_skipped(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(pytest.skip.Exception,
                       match="cats.train.4x10 needs 4 cards; 1 visible"):
        enough_cards(RANKS, cell_files(RANKS)[0]["chips"])
    enough_cards("cats.train.b40", 1)  # one card is enough: no skip
