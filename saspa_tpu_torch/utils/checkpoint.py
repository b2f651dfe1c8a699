"""Checkpoints of the train stage (counterpart of
saspa_tpu/utils/checkpoint.py, which writes orbax).

The contract is the reference's dict (fgvc/util.py:196-203,
fgvc/train.py:287-304): one `torch.save` file holding {"params",
"batch_stats", "feature_center", "logs"}, the model's
parameters and BatchNorm statistics as flat state_dicts on the CPU (the
flax paths with "." for "/"), and the logs also in a JSON sidecar beside
it.  Restoring into a model is size-tolerant, as the JAX package's
`_merge_size_tolerant` (and the reference's forgiving load_state_dict):
entries whose shape differs keep the model's value, with a warning; strict
raises.  `load_checkpoint` also reads a released WSDAN-CAL .pth (the
reference's {"logs", "state_dict", "feature_center"}, ResNet nets): its
state_dict goes through the CAL converter (weights/convert.py), every key
consumed, into the same params/batch_stats form.  An orbax checkpoint
directory (the JAX package's) raises.
"""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from saspa_tpu_torch.bridge import state_dict_from_flax
from saspa_tpu_torch.weights.convert import cal_net, convert_cal
from saspa_tpu_torch.weights.files import unwrap
from saspa_tpu_torch.weights.load import TrackingStateDict, WeightsMismatch, refuse_orbax, unconsumed


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        return obj.tolist()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    return obj


def split_state(model: torch.nn.Module) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(params, batch_stats) of a model as CPU f32 state_dicts: its
    parameters, and its buffers (BatchNorm's mean and var)."""
    params = {k: v.detach().float().cpu().clone() for k, v in model.named_parameters()}
    stats = {k: v.detach().float().cpu().clone() for k, v in model.named_buffers()}
    return params, stats


def save_checkpoint(path: str, model: torch.nn.Module, feature_center=None, logs: Optional[dict] = None) -> None:
    path = os.path.abspath(path)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    params, stats = split_state(model)
    payload = {"params": params, "batch_stats": stats}
    if feature_center is not None:
        payload["feature_center"] = feature_center.detach().float().cpu().clone()
    if logs is not None:
        payload["logs"] = _jsonable(logs)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    if logs is not None:
        with open(path + ".logs.json", "w") as f:
            json.dump(_jsonable(logs), f)


def load_checkpoint(path: str) -> dict:
    """The port's checkpoint, or a released WSDAN-CAL .pth in the same form
    (with "net": the ResNet its keys say)."""
    path = os.path.abspath(path)
    if os.path.isdir(path):
        refuse_orbax(path)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" not in obj:
        return obj
    sd = TrackingStateDict(unwrap(obj, path))
    params, stats = convert_cal(sd)
    left = unconsumed(sd)
    if left:
        raise WeightsMismatch(f"{path}: {len(left)} keys a WSDAN-CAL does not take: {left[:8]}")
    ckpt = {"params": state_dict_from_flax(params), "batch_stats": state_dict_from_flax(stats),
            "net": cal_net(sd)}
    if isinstance(obj.get("feature_center"), torch.Tensor):
        ckpt["feature_center"] = obj["feature_center"].float()
    if "logs" in obj:
        ckpt["logs"] = obj["logs"]
    return ckpt


def restore_into(model: torch.nn.Module, ckpt: dict, strict: bool = False) -> list:
    """Loads the checkpoint's params and batch_stats into `model`, keeping
    the model's value wherever a key is missing or its shape differs
    (strict: raises instead).  Returns the skipped keys."""
    own = model.state_dict()
    loaded = {**ckpt.get("params", {}), **ckpt.get("batch_stats", {})}
    skipped = [k for k, v in loaded.items() if k not in own or tuple(own[k].shape) != tuple(v.shape)]
    missing = [k for k in own if k not in loaded]
    if strict and (skipped or missing):
        raise ValueError(f"strict checkpoint restore failed: {len(skipped)} mismatched keys {skipped[:5]}, "
                         f"{len(missing)} missing keys {missing[:5]}")
    if skipped:
        logging.warning("checkpoint restore skipped %d mismatched keys: %s", len(skipped), skipped[:10])
    with torch.no_grad():
        for k, v in loaded.items():
            if k not in skipped:
                own[k].copy_(v.to(own[k].dtype))
    return skipped
