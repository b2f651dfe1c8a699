"""Contextual-bias evaluation on planes_biased (counterpart of
saspa_tpu/fgvc/val_biased.py).

Out of domain (fgvc/val_biased.py:55-57): Boeing on road and Airbus on
grass; every other test row is in domain.  A checkpoint is restored
strictly into WSDAN-CAL (M 32, bf16 on the card), BatchNorm statistics
included, and its raw logits alone are scored (no attention-crop TTA,
unlike the train stage's two-view validation), over the whole test split
(the partial last batch too): mean-class, overall, in-domain and
out-of-domain top-1, with the subsets' sizes.  `main` sweeps a folder as
the reference's __main__ does: the port's checkpoint files (a run's
`model.ckpt` under its save_dir) and released WSDAN-CAL `.pth` files, in the
folder or one level down; a checkpoint that does not fit the net prints
"Failed to load model" and the sweep goes on.  The JAX package's orbax
directories raise.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from saspa_tpu_torch import default_dtype, resolve_device
from saspa_tpu_torch.data.datasets import FGVCDataset, PlanesBiasedFiles
from saspa_tpu_torch.data.pipeline import InputPipeline
from saspa_tpu_torch.fgvc.metrics import MeanClassAccuracy, TopKAccuracy, per_class_stats, topk_correct
from saspa_tpu_torch.models.cal import WSDAN_CAL
from saspa_tpu_torch.utils.checkpoint import load_checkpoint, restore_into
from saspa_tpu_torch.weights.load import WeightsMismatch, refuse_orbax


def _ood_flags(files) -> np.ndarray:
    """(N,) int32 in the files' row order: 1 for Boeing on road and Airbus
    on grass, else 0."""
    ood = {("Boeing", "road"), ("Airbus", "grass")}
    return np.asarray([int((r["Plane"], r["Ground"]) in ood) for r in files.rows], np.int32)


def evaluate_checkpoint(ckpt_path: str, net: str = "resnet50", batch_size: int = 16, image_size=(224, 224),
                        num_attentions: int = 32, device=None, dtype: Optional[torch.dtype] = None) -> dict:
    """The test split's accuracies of one checkpoint (raises ValueError or
    WeightsMismatch where it does not fit the net).  dtype: the compute
    dtype, by default bf16 on the card and f32 on the CPU."""
    device = resolve_device(device)
    files = PlanesBiasedFiles(split="test")
    is_ood = _ood_flags(files)
    num_classes = files.num_classes
    model = WSDAN_CAL(num_classes=num_classes, M=num_attentions, net=net, dtype=dtype or default_dtype(device),
                      device=device).eval()
    restore_into(model, load_checkpoint(ckpt_path), strict=True)

    ds = FGVCDataset(files, split="test")
    pipe = InputPipeline(ds, batch_size=batch_size, resize=image_size, device=device, drop_last=False)
    mca = MeanClassAccuracy(num_classes)
    overall, id_acc, ood_acc = TopKAccuracy(), TopKAccuracy(), TopKAccuracy()
    cursor = 0  # the eval order is the split's row order
    with torch.no_grad():
        for X, y in pipe.iter_eval():
            logits = model(X)[0]  # raw logits only (val_biased.py:35-43)
            n = int(y.shape[0])
            flags = is_ood[cursor:cursor + n]
            cursor += n
            overall.update(topk_correct(logits, y).cpu().numpy(), n)
            c, cnt = per_class_stats(logits, y, num_classes)
            mca.update(c.cpu().numpy(), cnt.cpu().numpy())
            for subset, metric in ((flags == 0, id_acc), (flags == 1, ood_acc)):
                if subset.any():
                    idx = torch.as_tensor(np.where(subset)[0], device=logits.device)
                    metric.update(topk_correct(logits[idx], y[idx]).cpu().numpy(), int(subset.sum()))
    result = {"mean_class_acc": mca.value, "overall_acc": float(overall.value[0]), "id_acc": float(id_acc.value[0]),
              "ood_acc": float(ood_acc.value[0]), "n_id": id_acc.num_samples, "n_ood": ood_acc.num_samples}
    logging.info("val_biased %s: %s", ckpt_path, result)
    return result


def _checkpoint_files(folder: Path) -> list:
    return sorted(p for p in folder.iterdir() if p.is_file() and p.suffix in (".ckpt", ".pth"))


def _is_orbax(folder: Path) -> bool:
    return (folder / "ckpt").exists() or (folder / "_METADATA").exists()


def checkpoints_in(ckpt_folder: str) -> list:
    """The sweep's candidates: the file itself, else the folder's checkpoint
    files, else those of its subfolders (and their orbax directories, which
    raise when loaded)."""
    root = Path(ckpt_folder)
    if root.is_file():
        return [root]
    if _is_orbax(root):
        refuse_orbax(root)
    found = _checkpoint_files(root)
    if found:
        return found
    for folder in sorted(p for p in root.iterdir() if p.is_dir()):
        found += _checkpoint_files(folder) + sorted(c for c in folder.iterdir() if c.is_dir() and _is_orbax(c))
    return found


def main(ckpt_folder: str, net: str = "resnet50", batch_size: int = 16, device=None) -> dict:
    """Evaluates every checkpoint of the folder; {path: result} of those that
    loaded."""
    results = {}
    for ckpt in checkpoints_in(ckpt_folder):
        print(f"Running on {ckpt}")
        try:
            results[str(ckpt)] = evaluate_checkpoint(str(ckpt), net=net, batch_size=batch_size, device=device)
        except (ValueError, WeightsMismatch) as e:  # the reference main's skip (:72-74)
            print(f"Failed to load model: {e}")
            continue
        print(results[str(ckpt)])
    return results
