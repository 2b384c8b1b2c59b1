"""Why two gloo ranks' gradients part from one process's, on one card: the
readings behind the distributed phase of chip_smoke.py holding them to
the bit.

    python3 chip_dist_determinism.py

Makes chip_smoke.py's cases of the two-rank steps (dist_cases: the cats
step at DIST_CATS_BATCH a rank, the cars step at DIST_CARS_BATCH, the
classifier at DIST_CLS_BATCH, G's noise weights non-zero) and, first with
cuDNN's deterministic algorithms alone and then with torch's
(``use_deterministic_algorithms``, ``warn_only``), runs them on two gloo
ranks sharing the card (chip_smoke.dist_rank) and each half-batch step
twice in this process. This process empties its cache before each
spawn, as chip_smoke.two_ranks does (while it held the cache of its
references, the ranks ran short of the card's memory), and prints the
card's free memory there. For each case it prints whether the all-reduced
gradient equals the mean of the two half-batch gradients to the bit, its
worst tensor over that tensor's largest value and the relative L2 of all,
and whether the two runs of each half in this process were equal; then
the ops that warned of no deterministic algorithm. Needs one CUDA card;
the last line is a JSON object of those readings.
"""

import json
import os
import shutil
import sys
import tempfile

import torch

import chip_smoke as cs
from gangealing_torch.models.stylegan2 import Generator, GeneratorConfig
from gangealing_torch.parallel.launch import spawn_ranks

CASES = ("cats", "cars", "classifier")


def readings(dev, cases, path, d, name, full):
    out = os.path.join(d, f"ranks_{name}")
    os.makedirs(out)
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info(dev)[0] / 2 ** 30
    print(f"{name}: {free:.2f} GiB of the card free as the ranks start",
          flush=True)
    spawn_ranks(cs.dist_rank, 2, args=(path, out, full), backend="gloo",
                device="cuda:0", timeout=cs.DIST_TIMEOUT)
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    res = {"free_gib": free}
    with cs.deterministic(full) as seen:
        for case in CASES:
            runs = [[cs.dist_step(cases[case], dev, rows=(r, 2))[1]
                     for _ in range(2)] for r in range(2)]
            again = all(torch.equal(a[0][k], a[1][k])
                        for a in runs for k in a[0])
            mean = {k: (runs[0][0][k] + runs[1][0][k]) / 2
                    for k in runs[0][0]}
            got = ranks[0][case]["grads"]
            worst = max((float((got[k] - w).abs().max())
                         / max(float(w.abs().max()), 1e-30), k)
                        for k, w in mean.items())
            a = torch.cat([got[k].flatten() for k in mean])
            b = torch.cat([w.flatten() for w in mean.values()])
            res[case] = dict(
                equal=all(torch.equal(got[k], w) for k, w in mean.items()),
                worst=worst[0], worst_tensor=worst[1],
                l2=float((a - b).norm() / b.norm()),
                one_process_runs_equal=again)
            print(f"{name}, the {case} step: the ranks' gradient "
                  f"{'equals' if res[case]['equal'] else 'does not equal'}"
                  f" the half-batch mean to the bit; worst tensor "
                  f"{worst[1]} at {worst[0]:.3e} of its largest, all "
                  f"{res[case]['l2']:.3e} in relative L2; two runs of each "
                  f"half in this process equal: {again}", flush=True)
    res["warned"] = sorted(set(ranks[0]["warned"]) | seen)
    print(f"{name}: warned of no deterministic algorithm: "
          f"{res['warned']}")
    return res


def main():
    dev, card = cs.setup()
    d = tempfile.mkdtemp()
    gpath = os.path.join(d, "g.pt")
    gen = Generator(GeneratorConfig(),
                    generator=torch.Generator().manual_seed(3))
    torch.save({"g_ema": gen.state_dict()}, gpath)
    del gen
    cases = cs.dist_cases(dev, d, gpath)
    path = os.path.join(d, "cases.pt")
    torch.save(cases, path)
    result = {name: readings(dev, cases, path, d, name, name == "torch")
              for name in ("cudnn", "torch")}
    shutil.rmtree(d)
    print(card)
    print(json.dumps(result))


if __name__ == "__main__":
    sys.exit(main())
