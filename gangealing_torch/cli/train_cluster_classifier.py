"""Cluster classifier training CLI on one device (port of
gangealing_tpu/cli/train_cluster_classifier.py; reference
train_cluster_classifier.py).

    python -m gangealing_torch.cli.train_cluster_classifier \
        --exp-name cars_cls --ckpt results/cars/checkpoints/0250000.pt \
        --num_heads 4 --flips --sample_from_full_res --batch 40 [...]

The flags are the training CLI's (the JAX package's plus ``--device``,
default ``cuda``) and ``--cls_lr``. G, the STN's EMA and the latent
learner come from the GANgealing checkpoint ``--ckpt``; the classifier
resumes from its ``classifier`` entry when it has one and otherwise starts
from the similarity STN's encoder. Writes
<results>/<exp-name>/checkpoints/classifier.pt: the checkpoint's own
entries plus ``classifier``, the reference schema.
"""

import os

import torch

from gangealing_torch.apps.common import resolve_device
from gangealing_torch.cli import train as train_cli
from gangealing_torch.models.classifier import Classifier, classifier_config
from gangealing_torch.models.latent_learner import LatentLearner
from gangealing_torch.models.stn import ComposedSTN
from gangealing_torch.models.stylegan2 import Generator
from gangealing_torch.train.checkpoint import load_checkpoint, module_state
from gangealing_torch.train.classifier_train import (
    ClassifierTrainer, train_cluster_classifier, warm_start_from_stn)
from gangealing_torch.train.visuals import GANgealingWriter
from gangealing_torch.utils.download import find_model


def _frozen(module, sd):
    module.load_state_dict(module_state(sd), strict=True)
    return module.eval().requires_grad_(False)


def train_cluster_classifier_argparse():
    parser = train_cli.training_argparse()
    parser.add_argument("--cls_lr", type=float, default=0.001)
    return parser


def main(argv=None):
    """Train the classifier as the flags say. Returns (classifier, the last
    step's metrics)."""
    parser = train_cluster_classifier_argparse()
    args = parser.parse_args(argv)
    if not (args.num_heads > 1 or args.flips):
        parser.error("classifier training needs a clustering (or flips) "
                     "model")
    device = resolve_device(args.device)
    cfg = train_cli.build_configs(args)
    rngs = [torch.Generator().manual_seed(args.seed * 8 + k) for k in range(3)]
    _, perceptual_fn = train_cli.load_perceptual(args, device, rngs[2])

    ckpt_path, _ = find_model(args.ckpt)
    ckpt = load_checkpoint(ckpt_path)
    generator = _frozen(Generator(cfg.g, device=device), ckpt["g_ema"])
    stn = _frozen(ComposedSTN(cfg.t, device=device), ckpt["t_ema"])
    ll = _frozen(LatentLearner(cfg.ll, device=device), ckpt["ll"])

    classifier = Classifier(classifier_config(cfg.t, args.real_size),
                            device=device, generator=rngs[0])
    if "classifier" in ckpt:
        classifier.load_state_dict(module_state(ckpt["classifier"]),
                                   strict=True)
        print("Resuming cluster classifier training.")
    else:
        warm_start_from_stn(classifier, stn.state_dict())

    results_path = os.path.join(args.results, args.exp_name)
    writer = GANgealingWriter(results_path)
    try:
        metrics = train_cluster_classifier(
            ClassifierTrainer(cfg, classifier, generator, stn, ll,
                              perceptual_fn, cls_lr=args.cls_lr),
            iters=args.iter, cls_lr=args.cls_lr, period=args.period,
            decay=args.decay, tm=args.tm, seed=args.seed,
            log_every=args.log_every, writer=writer)
    finally:
        writer.close()
    out = os.path.join(results_path, "checkpoints", "classifier.pt")
    torch.save({**ckpt, "classifier": {
        k: v.detach().cpu() for k, v in classifier.state_dict().items()}},
        out)
    print(f"Saved classifier checkpoint to {out}")
    return classifier, metrics


if __name__ == "__main__":
    main()
