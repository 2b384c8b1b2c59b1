"""Faults planted under a cell's timed path, to show that its check fails.

Each is a context manager that breaks the program where the drivers call
it; the tests (``portbench/tests``) and ``portbench/calibrate.py`` run a
cell under them and read the check's numbers. The benchmark's own runs
never enter them.
"""

import contextlib

import torch

from gangealing_torch.train import state as train_state
from portbench.drivers import congeal, train, train_ranks


@contextlib.contextmanager
def _patched(module, name, value):
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def _train_fault(wrap):
    return _patched(train, "train_block", wrap(train.train_block))


def unchanged_state():
    """A train step that returns its state unchanged: the update is made
    and then undone."""
    def wrap(block):
        def broken(state, *args, **kw):
            kept = {k: v.detach().clone()
                    for k, v in train.learned(state).items()}
            out = block(state, *args, **kw)
            with torch.no_grad():
                for k, v in train.learned(state).items():
                    v.copy_(kept[k])
            return out
        return broken
    return _train_fault(wrap)


def half_batch():
    """Half of the batch left out of the step: the mean is taken over the
    rest."""
    def wrap(block):
        def broken(state, generator, perceptual_fn, zs, noises, *args, **kw):
            heads = state.cfg.t.num_heads
            half = zs[0].shape[0] // 2
            zs = [z[:half] for z in zs]
            noises = [([n[:half] for n in first],
                       [n[:half * heads] for n in second])
                      for first, second in noises]
            return block(state, generator, perceptual_fn, zs, noises, *args,
                         **kw)
        return broken
    return _train_fault(wrap)


def altered_update():
    """The answer altered where it is produced: the STN's update made
    with half again its learning rate."""
    def wrap(block):
        def broken(state, generator, perceptual_fn, zs, noises, psis, lr_ts,
                   *args, **kw):
            return block(state, generator, perceptual_fn, zs, noises, psis,
                         [1.5 * lr for lr in lr_ts], *args, **kw)
        return broken
    return _train_fault(wrap)


class _BrokenSTN(torch.nn.Module):
    def __init__(self, model, fault):
        super().__init__()
        self.model, self.fault = model, fault
        self.cfg = model.cfg

    def forward(self, x, **kw):
        if self.fault == "half":
            half = x.shape[0] // 2
            outs = self.model(x[:half], **kw)
            return [torch.cat([t, torch.zeros_like(t)]) if torch.is_tensor(t)
                    and t.shape[0] == half else t for t in outs]
        outs = list(self.model(x, **kw))
        out = outs[0].clone()
        out[0, 0, 0, 0] += 0.5
        return [out] + outs[1:]


def _stn_fault(fault):
    original = congeal.load_stn

    def load(*args, **kw):
        model, cfg = original(*args, **kw)
        broken = _BrokenSTN(model, fault)
        broken.stns = model.stns
        return broken, cfg
    return _patched(congeal, "load_stn", load)


def half_batch_served():
    """Half of each served batch left out: its outputs are zeros."""
    return _stn_fault("half")


def altered_output():
    """One congealed pixel of each batch altered where it is produced."""
    return _stn_fault("altered")


def unreduced_grads():
    """The exchange between cards left out: each rank steps on the
    gradients of its own share, the all-reduce skipped."""
    return _patched(train_state, "all_reduce_grads", lambda *modules: None)


@contextlib.contextmanager
def _on_every_rank(name, fault):
    """``fault`` here and, by name, in the ranks this process spawns."""
    with _patched(train_ranks, "FAULT", name), fault():
        yield


FAULTS = {"train": {"unchanged_state": unchanged_state,
                    "half_batch": half_batch,
                    "altered_update": altered_update},
          "congeal": {"half_batch": half_batch_served,
                      "altered_output": altered_output}}
FAULTS["train_ranks"] = {
    name: (lambda name=name, fault=fault: _on_every_rank(name, fault))
    for name, fault in dict(FAULTS["train"],
                            unreduced_grads=unreduced_grads).items()}
