"""Loading public checkpoint files into the port's models, strictly.

    file --read_state_dict--> {key: array} --converter--> flax tree
         --bridge--> state_dict --load_state_dict--> module

Every key of the file must be read by the converter and every parameter
and buffer of the module must come from the file.  The exceptions are the
ones the JAX converters document: HF's and BERT's `position_ids` buffers,
BatchNorm's `num_batches_tracked` counters, the OpenAI RN50 archive's
scalar metadata (`input_resolution`, `context_length`, `vocab_size`), the
lpips `scaling_layer` constants (checked against the model's, not
loaded), and the keys of `KIND_EXEMPT`.  Tied copies (BERT's MLM bias, T5's
embed_tokens and lm_head) are read and checked equal to the key loaded.  Anything else raises and names the keys.

Each load returns a report: the file, its keys, the parameters and
elements loaded, bytes and seconds; with REPORT_SUMS set (the chip smoke's
check, outside the seconds) also the f64 sum of what was loaded (`sum`),
and the f64 sum of the module's state after the load (`loaded_sum`) beside
the same values rounded to the module's dtypes (`rounded_sum`).
"""

from __future__ import annotations

import logging
import os
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from saspa_tpu_torch.bridge import state_dict_from_flax, state_dict_from_flax_variables
from saspa_tpu_torch.weights import convert
from saspa_tpu_torch.weights.files import read_state_dict
from saspa_tpu_torch.weights.sources import FAMILIES, PARTS, controlnet_part, family_of, find_source

EXEMPT_KEYS = ("position_ids", "num_batches_tracked")
RN50_METADATA = ("input_resolution", "context_length", "vocab_size")
# keys a kind's file may hold that its model does not take: the RN50
# archive's metadata; the momentum copies of a LAVIS pretraining checkpoint
# (the JAX CLI drops them before convert_blip_vqa); the cross-attention
# bias table of old t5 checkpoints, which HF's T5ForConditionalGeneration
# ignores too (_keys_to_ignore_on_load_unexpected)
KIND_EXEMPT = {"clip_rn50": RN50_METADATA, "blip_vqa": ("_m.", "momentum"),
               "t5": ("decoder.block.0.layer.1.EncDecAttention.relative_attention_bias.weight",)}
REPORT_SUMS = False
REPORTS: List[dict] = []  # every load's reports, for a caller that loads through an entry point


class WeightsMismatch(KeyError):
    """A file whose keys or shapes do not match the model."""

    def __str__(self):
        return str(self.args[0])


class TrackingStateDict(dict):
    """Records the keys a converter reads."""

    def __init__(self, sd):
        super().__init__(sd)
        self.read = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)


def strict_weights() -> bool:
    return os.environ.get("SASPA_STRICT_WEIGHTS", "") == "1"


def missing_weights(what: str, where) -> None:
    """No source for `what`: a warning and the seeded init, or under
    SASPA_STRICT_WEIGHTS=1 a FileNotFoundError."""
    if strict_weights():
        raise FileNotFoundError(f"no {what} under {where} and SASPA_STRICT_WEIGHTS=1 — outputs would be noise")
    logging.warning("no %s under %s — seeded random init (outputs are not meaningful)", what, where)


def unconsumed(tsd: TrackingStateDict, extra_exempt: Sequence[str] = ()) -> List[str]:
    exempt = EXEMPT_KEYS + tuple(extra_exempt)
    return sorted(k for k in tsd if k not in tsd.read and not any(e in k for e in exempt))


def _sum64(tensors) -> float:
    return float(sum(t.detach().double().sum().item() for t in tensors))


def load_module(module: torch.nn.Module, sd: Dict[str, torch.Tensor], what: str) -> dict:
    """Loads a bridged state_dict into `module`: the same keys and shapes,
    or a WeightsMismatch naming them."""
    own = module.state_dict()
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    shapes = sorted(f"{k}: file {tuple(sd[k].shape)}, model {tuple(own[k].shape)}"
                    for k in set(own) & set(sd) if tuple(own[k].shape) != tuple(sd[k].shape))
    if missing or extra or shapes:
        raise WeightsMismatch(f"{what}: {len(missing)} parameters not in the file {missing[:8]}, {len(extra)} "
                              f"not in the model {extra[:8]}, {len(shapes)} shapes differ {shapes[:8]}")
    module.load_state_dict(sd, strict=True)
    return {"params": len(sd), "module_params": len(own), "elements": sum(t.numel() for t in sd.values())}


def state_sums(module: torch.nn.Module, sd: Dict[str, torch.Tensor]) -> dict:
    """f64 sums of what was loaded, of the module's state after the load, and
    of what was loaded rounded to the module's dtypes."""
    after = module.state_dict()
    return {"sum": _sum64(sd.values()), "loaded_sum": _sum64(after.values()),
            "rounded_sum": _sum64(sd[k].to(after[k].dtype) for k in after)}


def _bridged(kind: str, tree) -> Dict[str, torch.Tensor]:
    return state_dict_from_flax_variables(tree) if kind in ("clip_rn50", "cal") else state_dict_from_flax(tree)


def _convert(kind: str, sd, module) -> list:
    """[(flax tree, module, model name)] of one file; BLIP's file feeds two."""
    if kind == "unet":
        return [(convert.convert_sd_unet(sd, module.cfg), module, "unet")]
    if kind == "controlnet":
        return [(convert.convert_controlnet(sd, module.cfg), module, "controlnet")]
    if kind == "vae":
        return [(convert.convert_vae(sd, module.cfg), module, "vae")]
    if kind == "clip_text":
        return [(convert.convert_clip_text_hf(sd, module.cfg.layers), module, "text")]
    if kind == "blip_diffusion":
        qformer, vision = module
        qc = qformer.cfg
        return [(convert.convert_blip_diffusion_qformer(sd, qc.layers, qc.cross_freq), qformer, "blip_qformer"),
                (convert.convert_blip_diffusion_vision(sd, vision.cfg.layers), vision, "blip_vision")]
    if kind == "clip_rn50":
        params, stats = convert.convert_clip_rn50(sd)
        return [({"params": params, "batch_stats": stats}, module, "clip")]
    if kind == "cal":
        params, stats = convert.convert_cal(sd)
        return [({"params": params, "batch_stats": stats}, module, "cal")]
    if kind == "lpips":
        return [(convert.convert_lpips(sd), module, "lpips")]
    if kind == "hed":
        return [(convert.convert_hed(sd), module, "hed")]
    if kind == "blip_caption":
        vit, text = module.visual_encoder.cfg.layers, module.text_decoder.cfg.layers
        return [(convert.convert_blip_caption(sd, vit, text), module, "blip_caption")]
    if kind == "blip_vqa":
        vit, text = module.visual_encoder.cfg.layers, module.text_decoder.cfg.layers
        return [(convert.convert_blip_vqa(sd, vit, text), module, "blip_vqa")]
    if kind == "t5":
        return [(convert.convert_t5(sd, module.cfg.layers), module, "t5")]
    raise ValueError(f"no converter of kind {kind!r}")


def load_file(path, kind: str, module, sd=None) -> List[dict]:
    """Reads, converts and loads one public file into `module` (for kind
    "blip_diffusion": the pair (qformer, vision)); one report per model."""
    t0 = time.perf_counter()
    sd = read_state_dict(path) if sd is None else sd
    tsd = TrackingStateDict(sd)
    try:
        converted = _convert(kind, tsd, module)
    except KeyError as e:
        raise WeightsMismatch(f"{path}: the {kind} converter found no key {e.args[0]!r}") from e
    left = unconsumed(tsd, KIND_EXEMPT.get(kind, ()))
    if left:
        raise WeightsMismatch(f"{path}: {len(left)} keys the {kind} model does not take: {left[:8]}")
    reports, loaded = [], []
    for tree, mod, name in converted:
        msd = _bridged(kind, tree)
        rep = load_module(mod, msd, f"{path} ({name})")
        reports.append({"model": name, "file": str(path), "kind": kind, "file_keys": len(tsd),
                        "unconsumed": 0, **rep})
        loaded.append((mod, msd))
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    nbytes = Path(path).stat().st_size
    for rep, (mod, msd) in zip(reports, loaded):
        rep.update(seconds=seconds, bytes=nbytes, **(state_sums(mod, msd) if REPORT_SUMS else {}))
    REPORTS.extend(reports)
    logging.info("loaded %s (%s, %.2f GB) in %.1f s", path, kind, nbytes / 1e9, seconds)
    return reports


def load_pipeline_weights(pipe, weights_dir) -> Tuple[List[str], List[dict]]:
    """Loads the pipeline's models whose files the tree holds.  The base
    family (text towers, UNet, VAE, and BLIP's towers) loads whole or not at
    all: a tree with some of its files but not all raises.  The ControlNet
    and HED load on their own; a ControlNet no file rule provides
    (`controlnet_part`) raises first.  Returns (the names of pipe.params
    loaded, reports)."""
    root = Path(weights_dir)
    family = FAMILIES.get(family_of(pipe.base_model))
    if family is None:
        raise ValueError(f"no weights-dir family for {pipe.base_model}")
    cn_part = controlnet_part(pipe.base_model, pipe.controlnet_kind, pipe.spec.is_xl) \
        if "controlnet" in pipe.params else None
    wanted = {"unet": family["unet"], "vae": family["vae"]}
    for i, part in enumerate(family["text"]):
        wanted[f"text{i}"] = part
    if "blip_vision" in pipe.params:
        wanted["blip"] = family["blip"]
    srcs = {k: find_source(root, part) for k, part in wanted.items()}
    found = [k for k, s in srcs.items() if s is not None]
    loaded, reports = [], []
    if found and len(found) < len(srcs):
        absent = {wanted[k]: PARTS[wanted[k]].srcs for k in srcs if srcs[k] is None}
        raise FileNotFoundError(f"{root}: the {family_of(pipe.base_model)} family is incomplete, no file for "
                                f"{absent}")
    if found:
        for k, path in srcs.items():
            if k.startswith("text"):
                reports += load_file(path, "clip_text", pipe.params["text"][int(k[4:])])
            elif k == "blip":
                towers = (pipe.params["blip_qformer"], pipe.params["blip_vision"])
                reports += load_file(path, "blip_diffusion", towers)
            else:
                reports += load_file(path, k, pipe.params[k])
        loaded += [k for k in pipe.params if k not in ("controlnet", "hed")]
    for name, part in (("controlnet", cn_part), ("hed", "hed")):
        path = find_source(root, part) if name in pipe.params else None
        if path is not None:
            reports += load_file(path, PARTS[part].kind, pipe.params[name])
            loaded.append(name)
    return loaded, reports


def refuse_orbax(path) -> None:
    """The JAX package's converted (orbax) checkpoints are not read here."""
    raise NotImplementedError(f"{path} is a checkpoint converted for the JAX package (orbax); the port reads the "
                              "public checkpoint files (README: the --weights_dir layout)")


def load_or_init(module, part: str, what: str, weights_dir, params, seed: int) -> Optional[List[dict]]:
    """A prompt tool's weights: a flax-shaped tree `params` (bridged), else
    the public file of `part` under weights_dir (the JAX package's converted
    directory of the same name refused), else the seeded init.  Returns the
    load reports or None."""
    from saspa_tpu_torch.models.layers import init_weights

    if params is not None:
        module.load_state_dict(state_dict_from_flax(params))
        return None
    reports = load_one(weights_dir, part, module, what, orbax=part) if weights_dir else None
    if reports is None:
        init_weights(module, seed)
    return reports


def load_one(weights_dir, part: str, module, what: str, orbax: Optional[str] = None) -> Optional[List[dict]]:
    """The file of `part` loaded into `module`, or None (with the warning or
    the strict raise of `missing_weights`) when the tree has none.  `orbax`:
    the JAX package's directory of the same weights, refused if it is all
    the tree has."""
    path = find_source(weights_dir, part) if weights_dir else None
    if path is None:
        if orbax and weights_dir and (Path(weights_dir) / orbax).exists():
            refuse_orbax(Path(weights_dir) / orbax)
        missing_weights(what, weights_dir or "(no --weights_dir)")
        return None
    return load_file(path, PARTS[part].kind, module)
