"""The stage metrics' readers: the median over units of the device ms
of one stage inside the traced window's root spans, and nothing where
the program records no spans or no device times."""

import types

import pytest

from gangealing_torch.utils import profiling
from gangealing_torch.utils.profiling import SpanTime
from portbench import run

STAGES = {"generator_ms.train": ("train.step", "train.generator"),
          "perceptual_ms.train": ("train.step", "train.perceptual"),
          "stn_ms.train": ("train.step", "stn.composed"),
          "backward_ms.train": ("train.step", "train.backward"),
          "update_ms.train": ("train.step", "train.update"),
          "encoder_ms.congeal": ("stn.composed", "stn.features"),
          "sample_ms.congeal": ("stn.composed", "stn.sample")}


def unit(root, stage, ms):
    return ([SpanTime(root, None, None)] +
            [SpanTime(stage, root, m) for m in ms] +
            [SpanTime("other", root, 5.0)])


@pytest.mark.parametrize("name", STAGES)
def test_reader_takes_the_median_unit(name, monkeypatch):
    """Each unit's spans of the stage summed, then the median over units:
    a stall in one unit (here 300 ms) does not move the reading."""
    root, stage = STAGES[name]
    asked = []

    def unit_spans(r, n):
        asked.append((r, n))
        return [unit(root, stage, [1.0, 2.0]), unit(root, stage, [300.0]),
                unit(root, stage, [4.0])]
    monkeypatch.setattr(profiling, "unit_spans", unit_spans)
    trace = types.SimpleNamespace(units=3)
    assert run.reader(name)(trace) == pytest.approx(4.0)
    assert asked == [(root, 3)]


@pytest.mark.parametrize("name", STAGES)
def test_reader_reads_nothing_where_nothing_was_recorded(name, monkeypatch):
    root, stage = STAGES[name]
    read = run.reader(name)
    # fewer roots than units
    monkeypatch.setattr(profiling, "unit_spans",
                        lambda r, n: [unit(root, stage, [1.0])])
    assert read(types.SimpleNamespace(units=2)) is None
    # spans without device times (no card)
    monkeypatch.setattr(profiling, "unit_spans",
                        lambda r, n: [unit(root, stage, [None])])
    assert read(types.SimpleNamespace(units=1)) is None
    # no unit holds the stage
    monkeypatch.setattr(profiling, "unit_spans",
                        lambda r, n: [unit(root, stage, [])])
    assert read(types.SimpleNamespace(units=1)) is None
    # a program without stage spans
    monkeypatch.delattr(profiling, "unit_spans")
    assert read(types.SimpleNamespace(units=1)) is None

