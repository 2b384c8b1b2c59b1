"""A run with its timed path broken underneath comes out not correct, and
so does each cell's control: the port's own bfloat16 path in place of the
float32 one that the configurations state. Each drives the whole run
through ``calibrate.reading``, on the CPU at a tiny size, past the
harness's look for a card."""

import pytest
import torch

from portbench import calibrate, faults, run
from portbench.tests.conftest import RANKS, SEED, cell_files, tiny_files

CELLS = [w["name"] for w in run.read_json(run.ROOT / "BENCHMARK.json")
         ["workloads"]] + [RANKS]
CASES = [(w, f) for w in CELLS
         for f in faults.FAULTS[cell_files(w)[2]["kind"]]]


def correct(workload, compute_dtype="float32", fault=None):
    return calibrate.reading(workload, SEED, torch.device("cpu"),
                             compute_dtype, fault, tiny_files(workload),
                             seconds=0.2)["correct"]


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_is_caught(workload, fault, two_threads):
    assert correct(workload, fault=fault) is False


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(workload, two_threads):
    assert correct(workload, "bfloat16") is False


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload, two_threads):
    line = calibrate.reading(workload, SEED, torch.device("cpu"),
                             cell_files=tiny_files(workload), seconds=0.2)
    assert line["correct"] is True
    assert set(line["checks"]) <= set(line["readings"])
