"""Flax param tree (numpy leaves) -> torch state_dicts for the port's models.

Torch parameter names follow the flax paths ("/" -> "."), so the mapping is
transposes only, the inverse of tools/convert_weights.py's t2f helpers:
conv kernels HWIO -> OIHW, dense kernels (in, out) -> (out, in).  Head
padding for the packed attention kernel is not stored; the models build
their padded weights once from these unpadded kernels.

Subtrees: "text" (a list with one tower per text encoder), "unet",
"controlnet", "vae", BLIP-Diffusion's "blip_vision" (CLIP ViT) and
"blip_qformer" (params), and the filter stage's "clip" (CLIP RN50) and
"cal" (WSDAN_CAL), which are flax variables: {"params", "batch_stats"}.
BatchNorm's mean and var live in flax's batch_stats collection and land on
the module's buffers of the same name.  Every leaf maps to one entry.

`train_state_from_flax` carries the JAX package's WSDAN-CAL TrainState
across: params and batch_stats as the "cal" state_dict, optax's momentum
(the trace of its chain) as one buffer a parameter, transposed as the
parameter is, the feature centers and the step, so a trajectory started in
JAX continues in the port (`load_train_state`).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, path + "/"))
        else:
            out[path] = np.asarray(v)
    return out


def _to_torch(path: str, leaf: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.array(leaf, dtype=np.float32))
    if path.rsplit("/", 1)[-1] == "kernel":
        if t.ndim == 4:  # HWIO -> OIHW
            t = t.permute(3, 2, 0, 1)
        elif t.ndim == 2:  # (in, out) -> (out, in)
            t = t.t()
    return t.contiguous()


def state_dict_from_flax(tree) -> Dict[str, torch.Tensor]:
    """One module's flax subtree -> its state_dict."""
    return {path.replace("/", "."): _to_torch(path, leaf) for path, leaf in _flatten(tree).items()}


def state_dict_from_flax_variables(variables) -> Dict[str, torch.Tensor]:
    """{"params", "batch_stats"?} of one flax module -> one state_dict; the
    two collections must not share a path."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"no port of the flax collections {sorted(unknown)}")
    sd = state_dict_from_flax(variables["params"])
    stats = state_dict_from_flax(variables.get("batch_stats", {}))
    clash = sorted(set(sd) & set(stats))
    if clash:
        raise KeyError(f"paths in both params and batch_stats: {clash[:5]}")
    sd.update(stats)
    return sd


def params_from_flax(params) -> dict:
    """{"text": [tower, ...], "unet", "controlnet"?, "vae", "blip_vision"?,
    "blip_qformer"?, "clip"?, "cal"?} flax params (variables for "clip" and
    "cal") -> {same keys: state_dict(s)}."""
    out = {}
    for name, sub in params.items():
        if name in ("clip", "cal"):
            out[name] = state_dict_from_flax_variables(sub)
        elif name == "text":
            out["text"] = [state_dict_from_flax(t) for t in sub]
        elif name in ("unet", "controlnet", "vae", "blip_vision", "blip_qformer"):
            out[name] = state_dict_from_flax(sub)
        else:
            raise KeyError(f"no port of the flax subtree {name!r}")
    return out


def train_state_from_flax(params, batch_stats, opt_state, feature_center, step=0) -> dict:
    """The JAX TrainState's fields -> {"cal": state_dict, "momentum":
    {name: tensor}, "feature_center": tensor, "step": int}.  `opt_state` is
    the chain's state tuple; its TraceState (the one with `.trace`) holds
    the momentum."""
    traces = [s.trace for s in opt_state if hasattr(s, "trace")]
    if len(traces) != 1:
        raise KeyError(f"expected one optax TraceState in the chain's state, found {len(traces)}")
    return {"cal": state_dict_from_flax_variables({"params": params, "batch_stats": batch_stats}),
            "momentum": state_dict_from_flax(traces[0]),
            "feature_center": torch.from_numpy(np.array(feature_center, dtype=np.float32)),
            "step": int(np.asarray(step))}


def load_train_state(state, bridged: dict) -> None:
    """Loads train_state_from_flax's output into a port TrainState
    (saspa_tpu_torch.fgvc.train), on its device, strictly."""
    model = state.model
    model.load_state_dict(bridged["cal"])
    if set(bridged["momentum"]) != set(state.momentum):
        raise KeyError("momentum buffers differ from the model's parameters: "
                       f"{sorted(set(bridged['momentum']) ^ set(state.momentum))[:5]}")
    with torch.no_grad():
        for name, buf in state.momentum.items():
            buf.copy_(bridged["momentum"][name])
        state.feature_center.copy_(bridged["feature_center"])
    state.step = bridged["step"]
