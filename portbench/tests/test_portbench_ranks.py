"""The data-parallel train cell on the CPU at a tiny size, over gloo at
world 2: the ranks run the same units, each on its share of the global
batch, and after the program's all-reduce the first gradient is that of
the one-process train cell at the global batch; a rank that holds a
forbidden module keeps the run from printing a result."""

import torch

from portbench import run
from portbench.drivers import train, train_ranks
from portbench.reference.train import ReferenceTrainer, stated_precision
from portbench.tests.conftest import RANKS as CELL
from portbench.tests.conftest import SEED, tiny_files


def ranks_cell(units):
    """Rank 0 of the tiny cell, ``units`` window units run and released;
    with the tiny traffic."""
    _, cfg, traffic, _, _, _ = tiny_files(CELL)
    cell = train_ranks.build(cfg, traffic, SEED, torch.device("cpu"), {})
    for _ in range(units):
        cell.run_unit()
    cell.release()
    return cell, cfg, traffic


def test_every_rank_ran_the_same_units(two_threads):
    # the window closes inside the second block of 2: rank 0 finishes it
    cell, _, traffic = ranks_cell(3)
    assert traffic["log_every"] == 2
    assert cell.units == 4
    assert [p["units"] for p in cell.peers] == [4] * (traffic["world"] - 1)
    assert [p.poll() for p in cell.procs] == [0] * (traffic["world"] - 1)
    assert not torch.distributed.is_initialized()


def close_leaves(ours, ref, rel):
    """Each leaf of ``ours`` within ``rel`` of ``ref``'s, in the norm of
    their difference over the larger of the leaf's norm and the median
    leaf's."""
    median = float(torch.stack([g.norm() for g in ref.values()]).median())
    return [k for k, g in ref.items()
            if float((ours[k] - g).norm()) > rel * max(float(g.norm()),
                                                       median)]


def test_first_gradient_is_the_global_batch_one(two_threads):
    cell, cfg, traffic = ranks_cell(1)
    world_batch = traffic["world"] * traffic["batch"]
    one = train.build(cfg, dict(traffic, kind="train", batch=world_batch),
                      SEED, torch.device("cpu"), {})
    (terms, grads, _), (terms_1, grads_1, _) = cell.passes[0], one.passes[0]
    for a, b in zip(terms[0], terms_1[0]):
        assert abs(a - b) <= 1e-6 * abs(b)
    assert close_leaves(grads, grads_1, 1e-5) == []
    # one rank's own share alone gives another gradient
    share = train.build(cfg, dict(traffic, kind="train"), SEED,
                        torch.device("cpu"), {})
    assert close_leaves(share.passes[0][1], grads_1, 1e-2) != []


def test_reference_in_chunks_takes_the_same_first_step(two_threads):
    _, cfg, traffic, _, _, _ = tiny_files("cats.train.b40")
    states = train.seeded_states(cfg, SEED, torch.device("cpu"))
    args = train.Inputs(cfg, 4, SEED, torch.device("cpu"))(
        traffic["start_iter"] + 1)
    out = {}
    for chunk in (None, 1):
        ref = ReferenceTrainer(cfg, states, torch.device("cpu"), chunk=chunk)
        with stated_precision():
            out[chunk] = ref.step(*args)
    (terms, grads), (terms_1, grads_1) = out[None], out[1]
    for a, b in zip(terms, terms_1):
        assert abs(a - b) <= 1e-6 * abs(a)
    # float32 round-off: the median leaf 1e-7, but the similarity stage
    # takes the gradient of its affine matrix, a sum over every point with
    # cancellation, which the CPU's matrix products order one way at a
    # batch of one and another at more: up to 2.9e-3 there, and 1e-4 in
    # the flow stage's first convolutions; float64 sides with the chunks
    # of one (3e-6)
    gaps, median_gap = train.leaf_gaps(grads_1, grads, list(grads))
    assert median_gap < 1e-5
    assert max(gaps.values()) < 1e-2


def test_a_rank_holding_jax_ends_the_run_without_a_result(
        tmp_path, monkeypatch, capsys, two_threads):
    """Only the spawned rank holds ``jax`` (a ``sitecustomize`` on its
    path): the run exits 3, prints no result and names the rank."""
    (tmp_path / "sitecustomize.py").write_text(
        "import sys, types\nsys.modules['jax'] = types.ModuleType('jax')\n")
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    args = run.parse(["--workload", CELL, "--seed", str(SEED),
                      "--seconds", "0.2", "--trace", "0"])
    assert run.run(args, torch.device("cpu"), tiny_files(CELL)) == 3
    out = capsys.readouterr()
    assert out.out == ""
    assert "jax (rank 1)" in out.err
