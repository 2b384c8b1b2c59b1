"""The rank side of tests/test_torch_parallel.py and
tests/test_torch_parallel_apps.py: functions that
``gangealing_torch.parallel.launch.spawn_ranks`` runs on each of two gloo
ranks on the CPU. They import the port only; the tests hold what each rank
writes against the JAX package. Each rank writes its results to
``<out>/<case>_r<rank>.pt``."""

import os

import numpy as np
import torch

from gangealing_torch.parallel import mesh


def _save(out, case, **results):
    torch.save(results, os.path.join(out, f"{case}_r{mesh.rank()}.pt"))


def helpers(out):
    """Each helper on rank-dependent inputs, empty stripes (n_total below
    the world) and unequal all_gatherv lengths among them."""
    r = mesh.rank()
    lin = torch.nn.Linear(3, 2)
    torch.nn.init.constant_(lin.weight, float(r))  # rank 0's must win
    mesh.broadcast_modules(lin)
    broadcast = lin.weight.detach().clone()
    lin(torch.full((1, 3), r + 1.0)).sum().backward()
    mesh.all_reduce_grads(lin)
    mesh.host_barrier("helpers")
    _save(out, "helpers",
          stripe=mesh.process_stripe(5),
          gathered=mesh.gather_process_stripes(
              [np.asarray(mesh.process_stripe(5), np.float32)[:, None]
               * [1, 10]], 5),
          # n_total 1: rank 1's stripe is empty and passes no chunk
          empty=mesh.gather_process_stripes(
              [np.full((1, 2, 3), 7, np.int16)] if r == 0 else [], 1),
          gatherv=mesh.all_gatherv_hosts(np.arange(10 * r,
                                                   10 * r + 3 - 2 * r)),
          hosts=mesh.all_gather_hosts(np.asarray([[r, -r]], np.float64)),
          rows=mesh.shard_global_batch(torch.arange(8).reshape(4, 2)),
          broadcast=broadcast, grad=lin.weight.grad.clone(),
          mean=mesh.mean_over_ranks(torch.tensor([1.0, 2.0]) * (r + 1)),
          world=mesh.world_size(), primary=mesh.is_primary())


def _modules(d):
    from gangealing_torch.models import latent_learner as tll
    from gangealing_torch.models import lpips as tlp
    from gangealing_torch.models import stn as tstn
    from gangealing_torch.models import stylegan2 as tg
    cfg = d["cfg"]
    generator = tg.Generator(cfg.g)
    generator.load_state_dict(d["g"], strict=True)
    generator.requires_grad_(False)
    t = tstn.ComposedSTN(cfg.t)
    t.load_state_dict(d["t"], strict=True)
    ll = tll.LatentLearner(cfg.ll)
    ll.load_state_dict(d["ll"], strict=True)
    vgg = tlp.LPIPS().eval().requires_grad_(False)
    vgg.load_state_dict(d["vgg"], strict=True)
    loss = tlp.make_perceptual_loss("vgg_ssl")
    return generator, t, ll, lambda x, y: loss(vgg, x, y)


def _grads(module):
    from gangealing_torch.io.torch_import import learnable_key_order
    named = dict(module.named_parameters())
    return {k: named[k].grad.clone()
            for k in learnable_key_order(module.state_dict())}


def train_steps(data, out):
    """One step of each training case in ``data`` (a torch.save'd dict of
    cases) on this rank's rows of its global batch; for a case with
    ``iters``, the classifier's training loop over that many
    iterations."""
    from gangealing_torch.models import classifier as tcls
    from gangealing_torch.train import classifier_train as tct
    from gangealing_torch.train import state as tstate
    from gangealing_torch.train.loop import rank_rows
    torch.set_num_threads(2)
    cases = torch.load(data, weights_only=False)
    for case, d in cases.items():
        generator, t, ll, pfn = _modules(d)
        if "iters" in d:  # the classifier's loop draws its own inputs
            classifier = tcls.Classifier(d["cls_cfg"])
            classifier.load_state_dict(d["classifier"], strict=True)
            trainer = tct.ClassifierTrainer(d["cfg"], classifier, generator,
                                            t.eval(), ll, pfn,
                                            cls_lr=d["lr"])
            m = tct.train_cluster_classifier(
                trainer, d["iters"], cls_lr=d["lr"], seed=d["seed"],
                progress=False)
            _save(out, case, metrics=m, params={
                k: v.detach().clone()
                for k, v in classifier.state_dict().items()})
            continue
        K = d["cfg"].t.num_heads
        z, noise = rank_rows(d["z"], d["noise"], K)
        if "classifier" not in d:
            state = tstate.TrainState(d["cfg"], t, ll)
            m = tstate.train_step(state, generator, pfn, z, d["psi"],
                                  d["lr_t"], d["lr_ll"], noise=noise)
            _save(out, case, metrics=m, t=_grads(state.t),
                  ll=_grads(state.ll))
            continue
        classifier = tcls.Classifier(d["cls_cfg"])
        classifier.load_state_dict(d["classifier"], strict=True)
        trainer = tct.ClassifierTrainer(d["cfg"], classifier, generator,
                                        t.eval(), ll, pfn, cls_lr=d["lr"])
        m = trainer.step(z, d["lr"], noise=noise)
        _save(out, case, metrics=m, grads=_grads(classifier),
              params={k: v.detach().clone()
                      for k, v in classifier.state_dict().items()})


def run(data, out):
    """Everything tests/test_torch_parallel.py holds, in one spawn."""
    helpers(out)
    train_steps(data, out)


def apps(data, out):
    """Each eval and AR app once over the ranks, as in ``data``."""
    from gangealing_torch.apps import congeal_dataset as tcong
    from gangealing_torch.apps import flow_scores as tflow
    from gangealing_torch.apps import mixed_reality as tmr
    from gangealing_torch.apps import pck as tpck
    from gangealing_torch.apps import propagate_to_images as tprop
    from gangealing_torch.apps import vis_correspondence as tvc
    from gangealing_torch.data.dataset import PCKDataset
    from gangealing_torch.models import classifier as tcls
    from gangealing_torch.models import stn as tstn
    torch.set_num_threads(2)
    d = torch.load(data, weights_only=False)

    def stn(sd):
        model = tstn.ComposedSTN(d["stn_cfg"])
        model.load_state_dict(sd, strict=True)
        return model.eval()
    model = stn(d["stn"])
    classifier = tcls.Classifier(d["cls_cfg"])
    classifier.load_state_dict(d["classifier"], strict=True)
    loader, n = tpck.pck_loader(PCKDataset(d["pck"], d["S"]), 2,
                                d["num_pairs"])
    _save(out, "apps",
          scores=tflow.compute_flow_scores(model, d["scores"], device="cpu",
                                           **d["scores_kw"]),
          pck=tpck.pck_transfer(model, loader, num_pairs=n, **d["pck_kw"]),
          used=tcong.align_and_filter_dataset(
              stn(d["zoom"]), d["images"], d["congealed"], device="cpu",
              **d["congeal_kw"]),
          propagated=tprop.propagate_to_images(
              model, d["prop_images"], out_dir=d["prop_out"],
              **d["prop_kw"]),
          video=tmr.run_gangealing_on_video(
              model, d["frames"], out_dir=d["video_out"], **d["video_kw"]),
          # one frame: rank 1's stripe is empty
          one_frame=tmr.run_gangealing_on_video(
              model, d["frames"][:1], **d["video_kw"]),
          average=tvc.average_image_video(model, d["avg_images"],
                                          num_frames=2, batch=2),
          buckets=tvc.bucket_real_images_by_cluster(
              classifier.eval(), d["bucket_images"], 2, batch=2))


def cli_train(argv, max_channels):
    """``cli.train`` in this rank, with its architectures' channels capped
    at ``max_channels`` as the CPU tests cap them."""
    import dataclasses
    from gangealing_torch.cli import train as tcli
    torch.set_num_threads(2)
    build = tcli.build_configs

    def capped(args):
        cfg = build(args)
        return dataclasses.replace(
            cfg, g=dataclasses.replace(cfg.g, max_channels=max_channels),
            t=dataclasses.replace(cfg.t, max_channels=max_channels))
    tcli.build_configs = capped
    tcli.main(argv)
