"""WS-DAN/CAL training: the train and eval steps and the epoch loop
(counterpart of saspa_tpu/fgvc/train.py).

Behavioural spec is fgvc/train.py:339-623:
  * 3-view forward (raw, attention crop, attention drop), composite loss
    CE(raw)/3 + CE(aux_cat) + CE(aug)*2/3 + center loss; with the CLIP
    teacher's logits (--use_target_soft_cross_entropy, fgvc/train.py:480-494)
    the CE terms become 0.5 * CE + 0.5 * the same three terms of the
    soft-target CE at T = 2 against the teacher's logits (WSDAN only);
  * feature-center EMA fc[y] += beta * (feat - normalize(fc[y])), beta 5e-2,
    a scatter that ACCUMULATES duplicate labels of a batch, as the JAX
    package's `.at[y].add` (torch's `fc[y] += d` would keep the last write);
  * SGD with momentum 0.9 and weight decay 1e-5 in optax's chain order
    (g + wd * p; buf = 0.9 * buf + g; p -= lr(step) * buf, step from 0),
    lr = base * 0.9 ** (step / (2 * batches_per_epoch));
  * eval: two-view TTA (raw + crop(theta 0.1, pad 0.05)) / 2;
  * val every 10 epochs and at the tail, early stop after 20 stale
    validations.

The step runs eagerly, with autograd over the model's f32 master weights
(the convolutions and fc compute in the model dtype, bf16 on the card).
BatchNorm uses the batch's statistics and updates its running ones under
no_grad; the second forward (crop and drop, 2B images) starts from the
statistics the first left, as the JAX step's `variables2`.  Every draw
comes from the step's threefry key split as the JAX step splits it
(k_model1, k_model2, k_crop, k_drop = split(key, 4)), so a step with the
same key draws what JAX draws; `draws` injects them instead.

Data parallelism (`mesh`, parallel/mesh.py; JAX's sharded step,
saspa_tpu/fgvc/train.py:259-329): one process a card, each holding the
state and taking its data index's contiguous rows of the global batch
(shard_batch; the model ranks of a data index take the same rows).  Every
draw is made for the global batch on every rank and sliced
(`utils/rng.py::Rows`; injected draws are global too), BatchNorm takes the
global batch's statistics, the gradients are one flat all_reduce divided
by the rank count (the shards are equal, so that is the global batch's
mean; the model ranks of a data index add equal gradients), the
feature-center scatter adds the gathered global delta at the gathered
labels, and the metrics are reduced over the data group before the host
reads them.  With the head sharded over the model axis
(parallel/head.py::shard_head, the dry run's tensor parallelism), each model
rank keeps its classes' rows of fc.kernel and their momentum, and each
shard's gradient is averaged over its own data group only.
So every rank ends a step as the one-process step on the global batch does,
and every decision the host makes (validation, early stop, divergence
abort, the best checkpoint) comes from reduced values, the same on every
rank.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from saspa_tpu_torch import resolve_device
from saspa_tpu_torch.fgvc import losses as L
from saspa_tpu_torch.fgvc.metrics import AverageMeter, MeanClassAccuracy, TopKAccuracy, per_class_stats, topk_correct
from saspa_tpu_torch.models.cal import WSDAN_CAL
from saspa_tpu_torch.models.layers import init_weights, sync_batch_norms
from saspa_tpu_torch.ops.batch_augment import batch_augment
from saspa_tpu_torch.parallel.mesh import (Mesh, all_reduce_mean_, all_reduce_sum, barrier, gather_rows,
                                           replicated)
from saspa_tpu_torch.utils import rng as rngs
from saspa_tpu_torch.utils.checkpoint import load_checkpoint, restore_into, save_checkpoint
from saspa_tpu_torch.utils.config import TrainConfig


@dataclass
class TrainState:
    """The model holds the params (f32 masters) and batch_stats (BatchNorm
    buffers); `momentum` is optax's trace, one buffer a parameter name."""

    model: WSDAN_CAL
    feature_center: torch.Tensor  # (num_classes, M * num_features) f32
    momentum: Dict[str, torch.Tensor] = field(default_factory=dict)
    step: int = 0


def lr_at(cfg: TrainConfig, num_batches_per_epoch: int, step: int, f=np.float32) -> float:
    """lr(step) = base * rate ** (step / (batches * duration)), in f32 as
    the JAX schedule computes it (f64 for f64 masters, as jax with x64);
    epoch + iter / batches == step / batches."""
    denom = f(float(max(num_batches_per_epoch, 1)) * cfg.lr_decay_duration)
    return float(f(cfg.learning_rate) * f(cfg.lr_decay_rate) ** (f(step) / denom))


def create_train_state(cfg: TrainConfig, num_classes: int, device=None, init_seed: Optional[int] = None) -> TrainState:
    """A seeded WSDAN_CAL (f32 masters, compute in cfg.compute_dtype; f32
    on the CPU), zero momentum and feature centers."""
    device = resolve_device(device)
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" and device.type == "cuda" else torch.float32
    model = WSDAN_CAL(num_classes=num_classes, M=cfg.num_attentions, net=cfg.net, dtype=dtype, device=device,
                      param_dtype=torch.float32)
    init_weights(model, cfg.seed if init_seed is None else init_seed)
    for p in model.parameters():
        p.requires_grad_(True)
    momentum = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    fc = torch.zeros(num_classes, cfg.num_attentions * model.num_features, device=device)
    return TrainState(model=model, feature_center=fc, momentum=momentum)


def sgd_update(state: TrainState, lr: float, weight_decay: float, momentum: float) -> None:
    """optax.chain(add_decayed_weights(wd), trace(momentum),
    scale_by_schedule(-lr)) applied in place; grads are the params' .grad."""
    names = [n for n, p in state.model.named_parameters()]
    params = [p for _, p in state.model.named_parameters()]
    with torch.no_grad():
        grads = torch._foreach_add([p.grad for p in params], params, alpha=weight_decay)  # g + wd * p
        bufs = [state.momentum[n] for n in names]
        torch._foreach_mul_(bufs, momentum)
        torch._foreach_add_(bufs, grads)  # buf = momentum * buf + g
        torch._foreach_add_(params, bufs, alpha=-lr)
    for p in params:
        p.grad = None


REGULAR_CE_RATIO = 0.5  # the hard CE's share of the blend with the teacher's soft targets


def _reduce_metrics(mesh: Optional[Mesh], metrics: dict) -> dict:
    """The metrics over the data axis, in one all_reduce: the loss averaged
    (the shards are equal), the counts summed."""
    if mesh is None or mesh.data_size == 1:
        return metrics
    names = list(metrics)
    flat = all_reduce_sum(mesh, torch.cat([metrics[k].double().reshape(-1) for k in names]))
    out, at = {}, 0
    for k in names:
        v = metrics[k]
        part = flat[at:at + v.numel()].view(v.shape)
        at += v.numel()
        out[k] = (part / mesh.data_size if k == "loss" else part).to(v.dtype)
    return out


def make_train_step(cfg: TrainConfig, num_batches_per_epoch: int, mesh: Optional[Mesh] = None):
    """train_step(state, X (B, 3, H, W) f32, y (B,) int, key, y_soft=None,
    draws=None, clip_logits=None) -> metrics (device tensors), updating
    `state` in place.  Under a mesh of more than one rank, X, y, y_soft and
    clip_logits are this rank's rows of the global batch (the module
    docstring), draws the global batch's, and the metrics the global
    batch's.

    y_soft (B, num_classes) f32, CutMix's soft labels, replaces y in every
    cross-entropy term (the aug and aux views repeat it as they repeat y);
    the metrics stay on the hard y.  clip_logits (B, num_classes): the CLIP
    teacher's, blended in when cfg.use_target_soft_cross_entropy and WSDAN
    is on (ignored otherwise, as in the JAX step).  draws injects every
    stochastic draw:
    {fake1 (B, M, h, w), pick1 (B, 2), fake2 (2B, M, h, w), pick2 (2B, 2),
    crop_theta (B,), drop_theta (B,)}."""
    beta = cfg.beta
    use_wsdan = not cfg.dont_use_wsdan
    use_soft_target = cfg.use_target_soft_cross_entropy

    def ce(logits, labels, soft):
        return L.cross_entropy(logits, labels) if soft is None else L.cross_entropy_soft(logits, soft)

    dp = 1 if mesh is None else mesh.data_size

    def train_step(state: TrainState, X: torch.Tensor, y: torch.Tensor, key, y_soft: Optional[torch.Tensor] = None,
                   draws: Optional[dict] = None, clip_logits: Optional[torch.Tensor] = None):
        k_model1, k_model2, k_crop, k_drop = rngs.split(key, 4)
        draws = draws or {}
        model = state.model
        y = y.long()
        rows1 = rows2 = None
        if dp > 1:  # this rank's rows of the batch (B) and of the crop + drop batch (2B)
            b = X.shape[0]
            rows1 = rngs.Rows(np.arange(mesh.data_index * b, (mesh.data_index + 1) * b), b * dp)
            rows2 = rngs.Rows(np.concatenate([rows1.index, rows1.total + rows1.index]), 2 * rows1.total)
            draws = {k: v[torch.as_tensor((rows2 if k in ("fake2", "pick2") else rows1).index, device=v.device)]
                     for k, v in draws.items()}

        fc_batch = state.feature_center[y]
        fc_batch = fc_batch / fc_batch.norm(dim=-1, keepdim=True).clamp_min(1e-12)  # F.normalize

        p_raw, p_aux, feature_matrix, attention_map = model(
            X, train=True, rngs_key=k_model1, fake_att=draws.get("fake1"), pick_idx=draws.get("pick1"), rows=rows1)
        if not use_wsdan:
            # dont_use_wsdan keeps the center term: CE(raw) + center (fgvc/train.py:501-503)
            loss = ce(p_raw, y, y_soft) + L.center_loss(feature_matrix, fc_batch)
            p_aux_cat, p_aug, y_aux, y_aug = p_aux, p_raw, y, y
        else:
            att = attention_map.detach()
            crop_images = batch_augment(X, att[:, 0], k_crop, mode="crop", theta=(0.4, 0.6), padding_ratio=0.1,
                                        thetas=draws.get("crop_theta"), rows=rows1)
            drop_images = batch_augment(X, att[:, 1], k_drop, mode="drop", theta=(0.2, 0.5),
                                        thetas=draws.get("drop_theta"), rows=rows1)
            p_aug, p_aux_aug, _, _ = model(torch.cat([crop_images, drop_images]), train=True, rngs_key=k_model2,
                                           fake_att=draws.get("fake2"), pick_idx=draws.get("pick2"), rows=rows2)
            y_aug = torch.cat([y, y])
            p_aux_cat = torch.cat([p_aux, p_aux_aug])
            y_aux = torch.cat([y, y_aug])
            soft_aug = None if y_soft is None else torch.cat([y_soft, y_soft])
            soft_aux = None if y_soft is None else torch.cat([y_soft, soft_aug])
            ce_term = (ce(p_raw, y, y_soft) / 3.0 + ce(p_aux_cat, y_aux, soft_aux)
                       + ce(p_aug, y_aug, soft_aug) * 2.0 / 3.0)
            loss = L.center_loss(feature_matrix, fc_batch)
            if use_soft_target and clip_logits is not None:
                t_aug = torch.cat([clip_logits, clip_logits])
                t_aux = torch.cat([clip_logits, t_aug])
                soft_term = (L.soft_target_cross_entropy_T(p_raw, clip_logits) / 3.0
                             + L.soft_target_cross_entropy_T(p_aux_cat, t_aux)
                             + L.soft_target_cross_entropy_T(p_aug, t_aug) * 2.0 / 3.0)
                loss = loss + REGULAR_CE_RATIO * ce_term + (1 - REGULAR_CE_RATIO) * soft_term
            else:
                loss = loss + ce_term

        loss.backward()
        if mesh is not None and mesh.size > 1:  # a sharded head's shards over their data group, the rest over all
            sharded = {id(p) for m in model.modules() if getattr(m, "model_sharded", False) for p in m.parameters()}
            all_reduce_mean_(mesh, [p.grad for p in model.parameters() if id(p) in sharded])
            all_reduce_mean_(mesh, [p.grad for p in model.parameters() if id(p) not in sharded], replicated=True)
        f = np.float64 if model.fc.kernel.dtype == torch.float64 else np.float32
        sgd_update(state, lr_at(cfg, num_batches_per_epoch, state.step, f), cfg.optimizer_weight_decay, cfg.momentum)
        with torch.no_grad():
            delta = beta * (feature_matrix.detach() - fc_batch)
            if dp > 1:  # the global batch's rows, in the one-process order
                delta, y_all = gather_rows(mesh, delta), gather_rows(mesh, y)
            else:
                y_all = y
            state.feature_center.index_add_(0, y_all, delta)  # accumulates duplicate labels
            metrics = {"loss": loss.detach(), "raw_correct": topk_correct(p_raw, y),
                       "aug_correct": topk_correct(p_aug, y_aug), "aux_correct": topk_correct(p_aux_cat, y_aux)}
        state.step += 1
        return _reduce_metrics(mesh, metrics)

    return train_step


@torch.no_grad()
def eval_step(state: TrainState, X: torch.Tensor, y: torch.Tensor, key, num_classes: int,
              mesh: Optional[Mesh] = None) -> dict:
    """Two-view TTA eval (fgvc/train.py:604-623); the crop's theta is fixed,
    so `key` draws nothing.  Under a mesh X and y are this rank's rows and
    the metrics the global batch's."""
    model = state.model
    y = y.long()
    p_raw, p_aux, _, attention_map = model(X)
    crop_images = batch_augment(X, attention_map[:, 0], key, mode="crop", theta=0.1, padding_ratio=0.05)
    p_crop, p_aux_crop, _, _ = model(crop_images)
    p = (p_raw + p_crop) / 2.0
    p_aux = (p_aux + p_aux_crop) / 2.0
    corrects, counts = per_class_stats(p, y, num_classes)
    return _reduce_metrics(mesh, {"loss": L.cross_entropy(p, y), "correct": topk_correct(p, y),
                                  "aux_correct": topk_correct(p_aux, y), "class_corrects": corrects,
                                  "class_counts": counts})


class Trainer:
    """The epoch loop over the input pipeline's device batches (X, y,
    y_soft or None), with the teacher's clip_logits as a fourth item when
    the soft-target CE is on.  Under a mesh of more than one rank, each
    batch is this rank's rows of the global batch (InputPipeline(mesh=...)
    yields them; shard_batch cuts them from a global one), the state starts
    from rank 0's, and rank 0 alone writes the best checkpoint.  On a (data,
    model) grid it runs data parallelism over the data axis with every
    parameter replicated over the model axis, as JAX's Trainer does."""

    def __init__(self, cfg: TrainConfig, num_classes: int, num_batches_per_epoch: int, device=None,
                 mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.mesh = mesh
        self.dp = 1 if mesh is None else mesh.data_size
        self.num_classes = num_classes
        self.num_batches_per_epoch = num_batches_per_epoch
        self.state = create_train_state(cfg, num_classes, device)
        self.restored = None
        if cfg.ckpt:
            ckpt = load_checkpoint(cfg.ckpt)
            own = self.state.model.state_dict()
            skipped = restore_into(self.state.model, ckpt)
            if "feature_center" in ckpt:
                self.state.feature_center.copy_(ckpt["feature_center"])
            loaded = {**ckpt.get("params", {}), **ckpt.get("batch_stats", {})}
            self.restored = {"file": cfg.ckpt, "skipped": skipped, "missing": [k for k in own if k not in loaded],
                             "feature_center": "feature_center" in ckpt, "pth": ckpt.get("report")}
            logging.info("restored checkpoint from %s: %s", cfg.ckpt, self.restored)
        if mesh is not None and mesh.size > 1:
            s = self.state
            replicated(mesh, [s.model, s.feature_center, s.momentum])
            sync_batch_norms(s.model, mesh)
        self.train_step = make_train_step(cfg, num_batches_per_epoch, mesh)
        self.best_val_acc = float("-inf")
        self.best_val_history: list = []
        self.logs: dict = {}

    def run_epoch(self, epoch: int, batches: Iterable) -> dict:
        cfg = self.cfg
        loss_meter, raw_acc, aug_acc, aux_acc = AverageMeter(), TopKAccuracy(), TopKAccuracy(), TopKAccuracy()
        t0 = time.time()
        n = 0
        # without WSDAN the "aug"/"aux" logits are the raw B-sized views
        den_aug, den_aux = (1, 1) if cfg.dont_use_wsdan else (2, 3)

        def consume(m, bs):
            loss_meter.update(float(m["loss"]), 1)
            raw_acc.update(m["raw_correct"].cpu().numpy(), bs)
            aug_acc.update(m["aug_correct"].cpu().numpy(), bs * den_aug)
            aux_acc.update(m["aux_correct"].cpu().numpy(), bs * den_aux)

        pending = None  # a step's metrics are read one step behind, so the host does not wait on the card
        for i, (X, y, y_soft, *teacher) in enumerate(batches):
            m = self.train_step(self.state, X, y, rngs.item_key(cfg.seed, "dropout", epoch, i), y_soft=y_soft,
                                clip_logits=teacher[0] if teacher else None)
            n += 1
            if pending is not None:
                consume(*pending)
            pending = (m, int(y.shape[0]) * self.dp)
        if pending is not None:
            consume(*pending)
        dt = time.time() - t0
        out = {"epoch": epoch, "train_loss": loss_meter.value, "train_raw_acc": raw_acc.value.tolist(),
               "train_aug_acc": aug_acc.value.tolist(), "train_aux_acc": aux_acc.value.tolist(),
               "epoch_time": dt, "steps": n}
        logging.info("Epoch %03d: loss %.4f, raw acc (%.2f, %.2f), %d steps, %.1fs",
                     epoch + 1, out["train_loss"], *out["train_raw_acc"][:2], n, dt)
        self.logs.update({f"train_{k}": v for k, v in out.items()})
        return out

    def evaluate(self, batches: Iterable, epoch: int = 0, is_test: bool = False) -> dict:
        loss_meter, acc, mca = AverageMeter(), TopKAccuracy(), MeanClassAccuracy(self.num_classes)

        def consume(m, bs):
            loss_meter.update(float(m["loss"]), 1)
            acc.update(m["correct"].cpu().numpy(), bs)
            mca.update(m["class_corrects"].cpu().numpy(), m["class_counts"].cpu().numpy())

        pending = None
        for i, (X, y) in enumerate(batches):
            m = eval_step(self.state, X, y, rngs.item_key(self.cfg.seed, "attention_pick", epoch, i),
                          self.num_classes, self.mesh)
            if pending is not None:
                consume(*pending)
            pending = (m, int(y.shape[0]) * self.dp)
        if pending is not None:
            consume(*pending)
        tag = "test" if is_test else "val"
        out = {f"{tag}_loss": loss_meter.value, f"{tag}_topk_accuracy": acc.value.tolist(),
               f"{tag}_mean_class_acc": mca.value, f"{tag}_acc_per_class": mca.accuracy_per_class().tolist()}
        logging.info("%s: loss %.4f acc (%.2f, %.2f)", tag, loss_meter.value, *acc.value[:2])
        self.logs.update(out)
        return out

    def maybe_save_best(self, val_acc: float, path: str) -> bool:
        """val_acc is the global batch's, so every rank decides alike; rank
        0 writes, and the others wait for it."""
        if val_acc > self.best_val_acc:
            self.best_val_acc = val_acc
            if self.mesh is None or self.mesh.rank == 0:
                save_checkpoint(path, self.state.model, feature_center=self.state.feature_center, logs=self.logs)
                logging.info("saved best checkpoint (val acc %.2f) to %s", val_acc, path)
            if self.mesh is not None:
                barrier(self.mesh)
            return True
        return False

    def should_validate(self, epoch: int) -> bool:
        cfg = self.cfg
        return epoch % cfg.val_every == 0 or epoch >= cfg.epochs - 1 or epoch == cfg.epochs - 5

    def should_stop_early(self) -> bool:
        """True when `early_stop_patience` validations in a row brought no
        new best (the reference's early stop, fgvc/train.py:394-395, can
        never fire; this is its stated intent, as in the JAX package)."""
        h = self.best_val_history
        p = self.cfg.early_stop_patience
        return len(h) > p and h[-1] <= h[-(p + 1)]
