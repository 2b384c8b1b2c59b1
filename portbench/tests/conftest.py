"""Shared fixtures of the benchmark's own tests: tiny copies of the cells'
files, small enough for the CPU, and the card for tests marked ``cuda``."""

import copy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import run  # noqa: E402

SEED = 2 ** 31 + 12345  # more than 32 signed bits hold


def tiny_files(workload):
    """``run.load_cell``'s tuple for ``workload`` at a size the CPU holds:
    the generator and STN widths capped, a batch of 2, as few units as a
    check needs. The limits are the cell's own."""
    files = list(run.load_cell(workload))
    cfg, traffic = copy.deepcopy(files[1]), dict(files[2])
    if traffic["kind"] == "train":
        cfg["generator"].update(size=64, style_dim=32, n_mlp=2,
                                channel_multiplier=1, max_channels=32)
        cfg["stn"].update(flow_size=64, supersize=64,
                          channel_multiplier=0.125, max_channels=32)
        traffic.update(batch=2, trace_units=2)
    else:  # congeal: the served STN is loaded as load_stn builds it,
        # at full width
        traffic.update(batch=2, pool=2, warmup=1, checked_batches=2,
                       trace_units=2)
    files[1], files[2] = cfg, traffic
    return tuple(files)


@pytest.fixture
def two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
