"""The train stage's orchestration (counterpart of saspa_tpu/fgvc/runner.py):
CLI args -> per-dataset config -> datasets and input pipelines -> the
Trainer's epoch loop with the reference's cadence (fgvc/train.py main()):
validation every 10 epochs and at the tail, the best validation's
checkpoint (with feature_center), early stop after 20 stale validations,
the divergence abort (val acc < 2% after epoch 30, fgvc/train.py:699-701),
the stop_aug_after_epoch switch, with --use_target_soft_cross_entropy
the CLIP RN50 zero-shot teacher whose logits each step blends in
(`make_clip_teacher`), and with --plot_per_class_acc a scatter of each
class's train samples against its accuracy at each validation and test
(fgvc/plots.py, under save_dir/plots/{val,test}/).  That flag needs
matplotlib: without it `train_config` raises, before the first step.

Runs on the card unless `device="cpu"` is passed.
"""

from __future__ import annotations

import logging
import os
from collections import Counter

import numpy as np


def train_config(args):
    """The TrainConfig of the train flags (saspa_tpu/fgvc/runner.py:27-48)."""
    from saspa_tpu_torch.utils.config import get_train_config

    if getattr(args, "plot_per_class_acc", False):
        from saspa_tpu_torch.fgvc.plots import require_matplotlib

        require_matplotlib()
    return get_train_config(
        args.dataset, seed=args.seed, epochs=args.epochs, learning_rate=args.learning_rate,
        batch_size=args.batch_size, weight_decay=args.weight_decay, net=args.net, aug_json=args.aug_json,
        aug_sample_ratio=args.aug_sample_ratio, limit_aug_per_image=args.limit_aug_per_image,
        stop_aug_after_epoch=args.stop_aug_after_epoch, special_aug=args.special_aug,
        train_sample_ratio=args.train_sample_ratio, dont_use_wsdan=args.dont_use_wsdan or None,
        use_cutmix=args.use_cutmix or None,
        use_target_soft_cross_entropy=getattr(args, "use_target_soft_cross_entropy", False) or None,
        few_shot=args.few_shot, ckpt=getattr(args, "ckpt", None))


def pipelines(cfg, device):
    """(train_ds, {"train", "val", "test"} InputPipelines, info)."""
    from saspa_tpu_torch.data.datasets import get_datasets
    from saspa_tpu_torch.data.pipeline import InputPipeline

    train_ds, val_ds, test_ds, info = get_datasets(
        cfg.dataset, resize=cfg.image_size, train_sample_ratio=cfg.train_sample_ratio, aug_json=cfg.aug_json,
        aug_sample_ratio=cfg.aug_sample_ratio, limit_aug_per_image=cfg.limit_aug_per_image,
        special_aug=cfg.special_aug, use_cutmix=cfg.use_cutmix, few_shot=cfg.few_shot, seed=cfg.seed)
    pipes = {"train": InputPipeline(train_ds, batch_size=cfg.batch_size, resize=cfg.image_size,
                                    train_transform=info["train_transform"], use_cutmix=info["use_cutmix"],
                                    seed=cfg.seed, num_threads=cfg.workers * 2, device=device),
             # eval batches of batch_size * 2, as the reference's (fgvc/train.py:316-319)
             "val": InputPipeline(val_ds, batch_size=cfg.batch_size * 2, resize=cfg.image_size, device=device),
             "test": (InputPipeline(test_ds, batch_size=cfg.batch_size * 2, resize=cfg.image_size, device=device)
                      if len(test_ds) else None)}
    return train_ds, pipes, info


def evaluate_checkpoint(args, device=None) -> dict:
    """The train flags' model restored from `args.ckpt`, evaluated on the
    test split (the metrics run_training logs for it)."""
    from saspa_tpu_torch import resolve_device
    from saspa_tpu_torch.fgvc.train import Trainer

    cfg = train_config(args)
    if not cfg.ckpt:
        raise ValueError("evaluate_checkpoint needs --ckpt")
    device = resolve_device(device)
    _, pipes, info = pipelines(cfg, device)
    trainer = Trainer(cfg, num_classes=info["num_classes"], num_batches_per_epoch=len(pipes["train"]),
                      device=device)
    return trainer.evaluate(pipes["test"].iter_eval(), epoch=0, is_test=True)


def run_training(args, device=None) -> dict:
    from saspa_tpu_torch import resolve_device
    from saspa_tpu_torch.fgvc.train import Trainer
    from saspa_tpu_torch.utils.logging_utils import MetricsWriter, init_logging

    cfg = train_config(args)
    device = resolve_device(device)
    save_dir = init_logging(logdir=args.logdir)
    cfg = cfg.replace(save_dir=save_dir)
    metrics = MetricsWriter(save_dir, use_wandb=getattr(args, "wandb", False))
    logging.info("train config: %s", cfg)

    train_ds, pipes, info = pipelines(cfg, device)
    train_pipe, val_pipe, test_pipe = pipes["train"], pipes["val"], pipes["test"]
    if len(val_pipe) == 0:
        logging.warning("val split (%d samples) smaller than the eval batch %d: no full val batch; "
                        "val metrics read 0 and the divergence abort is off", len(val_pipe.ds), cfg.batch_size * 2)
    if len(train_pipe) == 0:
        raise ValueError(f"train split ({len(train_ds)} samples) smaller than batch_size {cfg.batch_size}: "
                         "zero train batches per epoch; lower --batch_size")
    trainer = Trainer(cfg, num_classes=info["num_classes"], num_batches_per_epoch=len(train_pipe), device=device)
    teacher = None
    if cfg.use_target_soft_cross_entropy:
        teacher = make_clip_teacher(cfg.dataset, info["classes"], getattr(args, "weights_dir", None), device)

    plot_per_class = getattr(args, "plot_per_class_acc", False)
    if plot_per_class:
        counts = Counter(train_ds.labels)
        train_samples_per_class = {c: counts.get(c, 0) for c in range(info["num_classes"])}

    def log_eval(ev: dict, epoch: int, tag: str):
        metrics.log({"epoch": epoch, **{k: (v[0] if isinstance(v, list) else v) for k, v in ev.items()
                                        if not k.endswith("_acc_per_class")}})
        if plot_per_class:
            import matplotlib.pyplot as plt

            from saspa_tpu_torch.fgvc.plots import plot_samples_per_class_vs_accuracy

            plt.close(plot_samples_per_class_vs_accuracy(train_samples_per_class,
                                                         dict(enumerate(ev[f"{tag}_acc_per_class"])), epoch,
                                                         os.path.join(save_dir, "plots", tag)))

    ckpt_path = os.path.join(save_dir, cfg.model_name)
    for epoch in range(cfg.epochs):
        if cfg.aug_json and cfg.stop_aug_after_epoch and epoch >= cfg.stop_aug_after_epoch:
            train_ds.stop_aug = True
            logging.info("Reached stop_aug_after_epoch=%d, stopped augmentation", cfg.stop_aug_after_epoch)
        batches = train_pipe.iter_train(epoch)
        if teacher is not None:
            batches = ((X, y, y_soft, teacher(X)) for X, y, y_soft in batches)
        out = trainer.run_epoch(epoch, batches)
        metrics.log({"epoch": epoch, **{k: v for k, v in out.items() if np.isscalar(v)}})

        if trainer.should_validate(epoch):
            ev = trainer.evaluate(val_pipe.iter_eval(), epoch=epoch, is_test=False)
            val_acc = ev["val_topk_accuracy"][0]
            trainer.best_val_history.append(max(val_acc, trainer.best_val_acc))
            trainer.maybe_save_best(val_acc, ckpt_path)
            log_eval(ev, epoch, "val")
            if test_pipe is not None:
                log_eval(trainer.evaluate(test_pipe.iter_eval(), epoch=epoch, is_test=True), epoch, "test")
            if epoch > 30 and trainer.best_val_acc < 2 and len(val_pipe) > 0:
                logging.info("Validation accuracy is too low, stopping training")
                break
        if trainer.should_stop_early():
            logging.info("Validation accuracy has not improved in the last %d validations, stopping",
                         cfg.early_stop_patience)
            break
    return {**trainer.logs, "save_dir": save_dir, "ckpt_path": ckpt_path, "restored": trainer.restored,
            "pipeline_timings": {k: p.timings for k, p in pipes.items() if p is not None}}


def make_clip_teacher(dataset: str, classnames, weights_dir=None, device=None):
    """The soft-target CE path's teacher (saspa_tpu/fgvc/runner.py:163-191):
    teacher(X) -> (B, num_classes) f32 zero-shot logits, logit_scale * the
    unit image features of the ImageNet-normalised train batch X (B, 3, S,
    S), fed to CLIP RN50 as it is (as the reference does, fgvc/train.py:489),
    against the unit text features of one prompt a class, encoded once.
    `classnames` are in label-id order, so column j is the student's class j
    (the reference's set order scrambles them; the JAX package's
    documented divergence).  Planes and cars only.  The tower's attention
    pool takes 224^2 batches only, and raises on others, as the JAX
    teacher's does."""
    import torch

    from saspa_tpu_torch.filters.clip_filters import CLIPScorer

    assert dataset in ("planes", "cars"), "soft-target CE supports planes/cars (reference parity)"
    kind = "aircraft" if dataset == "planes" else "car"
    scorer = CLIPScorer("rn50", weights_dir=weights_dir, device=device)
    txt = torch.from_numpy(scorer.text_features([f"a photo of a {n}, a type of {kind}." for n in classnames]))
    txt = txt.to(scorer.device)
    scale = scorer.logit_scale

    @torch.no_grad()
    def teacher(X):
        feats = scorer.model.encode_image(X).float()
        return scale * feats @ txt.T

    teacher.scorer, teacher.text_features = scorer, txt
    return teacher
