"""The train stage's orchestration (counterpart of saspa_tpu/fgvc/runner.py):
CLI args -> per-dataset config -> datasets and input pipelines -> the
Trainer's epoch loop with the reference's cadence (fgvc/train.py main()):
validation every 10 epochs and at the tail, the best validation's
checkpoint (with feature_center), early stop after 20 stale validations,
the divergence abort (val acc < 2% after epoch 30, fgvc/train.py:699-701)
and the stop_aug_after_epoch switch.

Runs on the card unless `device="cpu"` is passed.  Not ported, and raising
with the ROADMAP item: the CLIP soft-target teacher
(--use_target_soft_cross_entropy, CLIP ViT-B/16), --plot_per_class_acc
(matplotlib) and the Inception and CBAM nets.
"""

from __future__ import annotations

import logging
import os

import numpy as np


def _check_supported(args) -> None:
    if getattr(args, "use_target_soft_cross_entropy", False):
        raise NotImplementedError("--use_target_soft_cross_entropy needs the CLIP ViT-B/16 teacher, which is not "
                                  "ported yet (ROADMAP Queue 1 item 11)")
    if getattr(args, "plot_per_class_acc", False):
        raise NotImplementedError("--plot_per_class_acc needs matplotlib (fgvc/plots.py is not ported; ROADMAP "
                                  "Queue 1 item 11)")


def train_config(args):
    """The TrainConfig of the train flags (saspa_tpu/fgvc/runner.py:27-48)."""
    from saspa_tpu_torch.utils.config import get_train_config

    _check_supported(args)
    return get_train_config(
        args.dataset, seed=args.seed, epochs=args.epochs, learning_rate=args.learning_rate,
        batch_size=args.batch_size, weight_decay=args.weight_decay, net=args.net, aug_json=args.aug_json,
        aug_sample_ratio=args.aug_sample_ratio, limit_aug_per_image=args.limit_aug_per_image,
        stop_aug_after_epoch=args.stop_aug_after_epoch, special_aug=args.special_aug,
        train_sample_ratio=args.train_sample_ratio, dont_use_wsdan=args.dont_use_wsdan or None,
        use_cutmix=args.use_cutmix or None, few_shot=args.few_shot, ckpt=getattr(args, "ckpt", None))


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

    def log_eval(ev: dict, epoch: int):
        metrics.log({"epoch": epoch, **{k: (v[0] if isinstance(v, list) else v) for k, v in ev.items()
                                        if not k.endswith("_acc_per_class")}})

    ckpt_path = os.path.join(save_dir, cfg.model_name)
    for epoch in range(cfg.epochs):
        if cfg.aug_json and cfg.stop_aug_after_epoch and epoch >= cfg.stop_aug_after_epoch:
            train_ds.stop_aug = True
            logging.info("Reached stop_aug_after_epoch=%d, stopped augmentation", cfg.stop_aug_after_epoch)
        out = trainer.run_epoch(epoch, train_pipe.iter_train(epoch))
        metrics.log({"epoch": epoch, **{k: v for k, v in out.items() if np.isscalar(v)}})

        if trainer.should_validate(epoch):
            ev = trainer.evaluate(val_pipe.iter_eval(), epoch=epoch, is_test=False)
            val_acc = ev["val_topk_accuracy"][0]
            trainer.best_val_history.append(max(val_acc, trainer.best_val_acc))
            trainer.maybe_save_best(val_acc, ckpt_path)
            log_eval(ev, epoch)
            if test_pipe is not None:
                log_eval(trainer.evaluate(test_pipe.iter_eval(), epoch=epoch, is_test=True), epoch)
            if epoch > 30 and trainer.best_val_acc < 2 and len(val_pipe) > 0:
                logging.info("Validation accuracy is too low, stopping training")
                break
        if trainer.should_stop_early():
            logging.info("Validation accuracy has not improved in the last %d validations, stopping",
                         cfg.early_stop_patience)
            break
    return {**trainer.logs, "save_dir": save_dir, "ckpt_path": ckpt_path, "restored": trainer.restored,
            "pipeline_timings": {k: p.timings for k, p in pipes.items() if p is not None}}
