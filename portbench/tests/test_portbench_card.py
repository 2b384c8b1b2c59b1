"""Each cell once on the card, short, through the command the driver runs:
exit 0, a correct result line from the card. Run on the card with
``python -m pytest -m cuda portbench/tests``."""

import json
import subprocess
import sys

import pytest

from portbench import run

CELLS = [w["name"] for w in run.read_json(run.ROOT / "BENCHMARK.json")
         ["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(workload, card):
    proc = subprocess.run(
        [sys.executable, str(run.BENCH / "run.py"), "--workload", workload,
         "--seed", str(2 ** 31 + 77), "--seconds", "2", "--trace", "0"],
        cwd=run.ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
