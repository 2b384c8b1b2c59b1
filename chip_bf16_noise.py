"""How far two bfloat16 evaluations of a training step part, on one card:
the readings behind chip_smoke.py's bfloat16 step gates.

    python3 chip_bf16_noise.py

First one bfloat16 conv of each kind the steps run (a 3x3 at 512 and at
128 channels, a depthwise 4x4 FIR) and its backward to the input (with a
seeded bfloat16 cotangent) on the card, with cuDNN and with the native
convolutions, against the CPU: the share of outputs a unit in the last
place apart and each one's error from the float64 result of the same
bfloat16 inputs. Then chip_smoke.py's batch-2 steps (step_grads,
cluster_step_grads) in float32 and in bfloat16 on the card and on the
CPU path, at the cats states (the state the float32 cli.train run of
chip_smoke.py's train phase writes, the identity init, the state the
bfloat16 cats run writes) and the state the bfloat16 cars run writes, for
z seeds 7 to 9, each pair read by chip_smoke.compare_steps: the card
against the CPU path in float32 (how well conditioned the state is) and
in bfloat16 (loss terms, the worst gradient tensor, relative L2, each
beside its gate in BF16_GATES or BF16_CLUSTER_GATES), and the CPU path's
bfloat16 against its float32 (how far bfloat16 rounding itself moves the
step). Needs one CUDA card; the last line is a JSON object with each
state's largest readings and how many seeds passed each gate.
"""

import dataclasses
import json
import os
import sys
import tempfile

import torch
import torch.nn.functional as F

import chip_smoke as cs

SEEDS = (7, 8, 9)


def layers(dev, card):
    g = torch.Generator().manual_seed(0)
    cases = {
        "3x3 512 ch 16 px": (torch.randn(2, 512, 16, 16, generator=g),
                             torch.randn(512, 512, 3, 3, generator=g) / 68,
                             1),
        "3x3 128 ch 256 px": (torch.randn(2, 128, 256, 256, generator=g),
                              torch.randn(128, 128, 3, 3, generator=g) / 34,
                              1),
        "depthwise 4x4 128 ch": (torch.randn(2, 128, 131, 131, generator=g),
                                 torch.rand(128, 1, 4, 4, generator=g), 128),
    }
    for name, (x, w, groups) in cases.items():
        xb, wb = x.bfloat16(), w.bfloat16()
        shape = F.conv2d(xb, wb, padding=1, groups=groups).shape
        cot = torch.randn(shape, generator=g).bfloat16()

        def run(d, dtype=None):
            xi = xb.to(d, dtype).requires_grad_()
            y = F.conv2d(xi, wb.to(d, dtype), padding=1, groups=groups)
            dx, = torch.autograd.grad(y, xi, cot.to(d, dtype))
            return y.detach().double().cpu(), dx.double().cpu()

        ref, exact = run("cpu"), run("cpu", torch.float64)
        for label, enabled in (("cuDNN", True), ("native", False)):
            torch.backends.cudnn.enabled = enabled
            got = run(dev)
            torch.backends.cudnn.enabled = True
            for part, y, r, e in zip(("conv", "its d/dinput"), got, ref,
                                     exact):
                print(f"bf16 {name} {part}, card ({label}) against the CPU: "
                      f"{float((y != r).float().mean()):.4%} apart, by at "
                      f"most {float((y - r).abs().max()):.3e}; from float64 "
                      f"card {float((y - e).abs().max()):.3e}, CPU "
                      f"{float((r - e).abs().max()):.3e} [{card}]",
                      flush=True)


def batch2(cfg, seed, clustered):
    if clustered:
        return cs.cluster_step_batch2(cfg, seed)
    g = torch.Generator().manual_seed(seed)
    z = torch.randn(2, cfg.g.style_dim, generator=g)
    return z, [[torch.randn(s, generator=g) for s in cfg.g.noise_shapes(2)]
               for _ in range(2)]


def table(what, cfg, t, ll, gen, perc, dev, card, clustered=False):
    """Each seed's readings; returns the largest worst-tensor error and L2
    of the bfloat16 card-against-CPU steps over the seeds whose
    assignments agree, and how many of them were within each gate."""
    bf16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    fn = cs.cluster_step_grads if clustered else cs.step_grads
    gates = cs.BF16_CLUSTER_GATES if clustered else cs.BF16_GATES
    cpu = torch.device("cpu")
    found = {"tensor": 0.0, "l2": 0.0, "seeds": 0, "terms_within": 0,
             "tensor_within": 0, "l2_within": 0}
    for seed in SEEDS:
        z, noise = batch2(cfg, seed, clustered)
        r = {(c.compute_dtype, d.type): fn(c, t, ll, gen, perc, d, z, noise)
             for c in (f32, bf16) for d in (dev, cpu)}
        if clustered and len({tuple(v[2].tolist()) for v in r.values()}) > 1:
            print(f"{what}, z seed {seed}: assignments "
                  f"{[v[2].tolist() for v in r.values()]} apart, skipped",
                  flush=True)
            continue
        cond = cs.compare_steps(r["float32", "cuda"][:2],
                                r["float32", "cpu"][:2])
        rel, worst, l2 = cs.compare_steps(r["bfloat16", "cuda"][:2],
                                          r["bfloat16", "cpu"][:2])
        gap = cs.compare_steps(r["bfloat16", "cpu"][:2],
                               r["float32", "cpu"][:2])
        found["tensor"] = max(found["tensor"], worst[0])
        found["l2"] = max(found["l2"], l2)
        found["seeds"] += 1
        for key, value, gate in (("terms_within", rel, gates[0]),
                                 ("tensor_within", worst[0], gates[1]),
                                 ("l2_within", l2, gates[2])):
            found[key] += value <= gate
        print(f"{what}, z seed {seed}: float32 card vs CPU L2 "
              f"{cond[2]:.3e}; bfloat16 card vs CPU terms {rel:.3e}, worst "
              f"tensor {worst[1]} {worst[0]:.3e}, L2 {l2:.3e} (gates "
              f"{gates}); CPU bfloat16 vs float32 terms {gap[0]:.3e}, "
              f"worst tensor {gap[1][1]} {gap[1][0]:.3e}, L2 {gap[2]:.3e} "
              f"[{card}]", flush=True)
    return found


def main():
    dev, card = cs.setup()
    layers(dev, card)
    d = tempfile.mkdtemp()
    reals = cs.real_lmdb(os.path.join(d, "reals"))
    state, gen, perc, _, _ = cs.cli_run(dev, reals)
    cfg = state.cfg
    found = {"cats float32 state": table(
        "cats, the float32 run's state", cfg, state.t, state.ll, gen, perc,
        dev, card)}
    t_id = cs.ComposedSTN(cfg.t, device=dev,
                          generator=torch.Generator().manual_seed(6))
    found["cats identity init"] = table("cats, the identity init", cfg,
                                        t_id, state.ll, gen, perc, dev, card)
    del state
    gpath = os.path.join(d, "g.pt")
    torch.save({"g_ema": cs.Generator(cs.GeneratorConfig(),
                generator=torch.Generator().manual_seed(3)).state_dict()},
               gpath)
    state, gen, perc, _ = cs.train_cli.main(cs.cats_argv(
        os.path.join(d, "cats"), gpath, cs.BF16_ITERS, "--vis_every", "0",
        "--compute_dtype", "bfloat16"))
    found["cats bfloat16 state"] = table(
        "cats, the bfloat16 run's state", state.cfg, state.t, state.ll, gen,
        perc, dev, card)
    del state
    state, gen, perc, _ = cs.train_cli.main(cs.cars_argv(
        os.path.join(d, "cars"), gpath, cs.CARS_BATCH, cs.CARS_ITERS,
        "--load_G_only", "--compute_dtype", "bfloat16"))
    found["cars bfloat16 state"] = table(
        "cars, the bfloat16 run's state", state.cfg, state.t, state.ll, gen,
        perc, dev, card, clustered=True)
    print(card)
    print(json.dumps(found))


if __name__ == "__main__":
    sys.exit(main())
