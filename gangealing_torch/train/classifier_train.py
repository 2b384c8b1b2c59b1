"""Cluster classifier training, after GANgealing, with everything else
frozen.

Port of gangealing_tpu/train/classifier_train.py (reference
train_cluster_classifier.py:30-137,175-215) on one device. Each step makes
fakes, assigns each to the head (and flip) whose congealed image is
nearest its target under the frozen STN, and trains the classifier with
cross-entropy on those assignments. The classifier starts from the
similarity STN's encoder (:184-189).
"""

import torch
import torch.nn.functional as F

from gangealing_torch.models.classifier import reverse_topk_accuracy
from gangealing_torch.train.annealing import lr_used_at_iter
from gangealing_torch.train.losses import assign_fake_images_to_clusters
from gangealing_torch.train.loop import iteration_rng
from gangealing_torch.train.state import make_adam, set_lr


@torch.no_grad()
def warm_start_from_stn(classifier, t_state):
    """Copy the similarity STN's weights (``stns.0.*`` of a ComposedSTN's
    state_dict, or a bare STN's) into the classifier's tensors of the same
    name and shape (train_cluster_classifier.py:184-189). Returns the
    names copied; the rest keep their init."""
    prefix = "stns.0." if any(k.startswith("stns.0.") for k in t_state) \
        else ""
    copied = []
    for k, v in classifier.state_dict().items():
        src = t_state.get(prefix + k)
        if src is not None and src.shape == v.shape:
            v.copy_(src)
            copied.append(k)
    return copied


class ClassifierTrainer:
    """The classifier, its Adam, and the frozen G, STN, latent learner and
    perceptual loss of one GANgealing run. ``cfg``: the run's
    train.state.TrainConfig (its batch, heads, flips and padding)."""

    def __init__(self, cfg, classifier, generator, stn, ll, perceptual_fn,
                 cls_lr=0.001):
        self.cfg = cfg
        self.classifier = classifier.train()
        self.generator, self.stn, self.ll = generator, stn, ll
        self.perceptual_fn = perceptual_fn
        self.optim = make_adam(classifier, cls_lr)
        self.total_clusters = cfg.t.num_heads * (1 + cfg.flips)

    def step(self, z, lr, noise=None, rng=None):
        """One iteration at learning rate ``lr``. Returns the metrics as
        detached device tensors: "cross_entropy", "acc@1", "acc@2" (the
        logits before the update against the distances), "gt_counts" and
        "pred_counts" (each cluster's share of the batch), and "labels",
        the assignments."""
        cfg = self.cfg
        batch = z.shape[0]
        with torch.no_grad():
            _, labels, _, _, _, resized, distances = \
                assign_fake_images_to_clusters(
                    self.generator, self.stn, self.ll, self.perceptual_fn, z,
                    0.0, cfg.t.num_heads, cfg.flips, freeze_ll=True,
                    sample_from_full_res=cfg.sample_from_full_res,
                    padding_mode=cfg.padding_mode, noise=noise, rng=rng)
        set_lr(self.optim, lr)
        self.optim.zero_grad(set_to_none=True)
        logits = self.classifier(resized[:batch])
        xent = F.cross_entropy(logits, labels)
        xent.backward()
        self.optim.step()
        logits = logits.detach()
        count = lambda x: torch.bincount(
            x, minlength=self.total_clusters).float() / batch
        return {"cross_entropy": xent.detach(),
                "acc@1": reverse_topk_accuracy(distances, logits, k=1),
                "acc@2": reverse_topk_accuracy(distances, logits, k=2),
                "gt_counts": count(labels),
                "pred_counts": count(logits.argmax(dim=1)),
                "labels": labels}


def train_cluster_classifier(trainer, iters, cls_lr=0.001, period=2500.0,
                             decay=0.9, tm=2, seed=0, log_every=25,
                             writer=None, progress=True):
    """Iterations 1 .. ``iters``. The learning rate of iteration i is the
    one the reference's scheduler has left after i - 1 steps, with no psi
    annealing (train_cluster_classifier.py:106-107,148). Returns the last
    step's metrics."""
    cfg = trainer.cfg
    device = next(trainer.classifier.parameters()).device
    metrics = None
    for i in range(1, iters + 1):
        lr = lr_used_at_iter(i, cls_lr, 0, period, t_mult=tm, decay=decay)
        rng = iteration_rng(seed, i, device)
        z = torch.randn(cfg.batch, cfg.g.style_dim, generator=rng,
                        device=device)
        metrics = trainer.step(z, lr, rng=rng)
        if i % log_every == 0 or i == 1:
            m = {k: float(metrics[k])
                 for k in ("cross_entropy", "acc@1", "acc@2")}
            if writer is not None:
                writer.add_scalar("Loss/CrossEntropy", m["cross_entropy"], i)
                writer.add_scalar("Loss/Accuracy@1", m["acc@1"], i)
                writer.add_scalar("Loss/Accuracy@2", m["acc@2"], i)
            if progress:
                print(f"\r[{i}/{iters}] xent={m['cross_entropy']:.4f} "
                      f"acc@1={m['acc@1']:.3f}", end="", flush=True)
    if progress:
        print()
    return metrics
