"""Datasets of the train stage (counterpart of saspa_tpu/data/datasets.py).

Each of the six datasets becomes a list of image files and integer labels,
parsed from its annotation files with the JAX package's split semantics (the
val carve-outs from datasets_files/*.txt).  The roots default to
$SASPA_DATA_ROOT, read when a reader is constructed.  The planes-biased csv
is read with the csv module (the machine with the card has no pandas).

`AugSampler` is the reference AugWrapperDataset's stochastic
original/augmented swap (fgvc/datasets/aug_wrapper_dataset.py:106-171), a
`random.Random(seed)` drawn in the JAX package's order, so the port
substitutes the same paths; `FGVCDataset` adds the train-side subsetting
(train_sample_ratio, few-shot, the ratio-1 drop, stop_aug), and
`get_datasets` builds the three splits.
"""

from __future__ import annotations

import csv
import json
import logging
import random as pyrandom
import warnings
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from saspa_tpu_torch.data.registry import DATASETS_FILES, data_root


def _val_carve_out(files: List[str], labels: List[int], split: str, val_txt: str, tail: int):
    """Keeps the val rows (split == "val") or the rest, matching the last
    `tail` path parts against datasets_files/<val_txt>."""
    with open(DATASETS_FILES / val_txt) as f:
        val_files = set(line.strip() for line in f)
    kept = [(p, lab) for p, lab in zip(files, labels)
            if (split == "val") == (str(Path(*Path(p).parts[-tail:])) in val_files)]
    return [p for p, _ in kept], [lab for _, lab in kept]


class _Files:
    image_files: List[str]
    labels: List[int]
    classes: List[str]
    dataset_name: str

    @property
    def num_classes(self) -> int:
        return len(set(self.labels)) if not self.classes else len(self.classes)


class FGVCAircraftFiles(_Files):
    """FGVC-Aircraft variant-level annotations (torchvision-compatible)."""

    dataset_name = "planes"

    def __init__(self, root: Optional[str] = None, split: str = "train"):
        root = Path(root or (data_root() / "FGVC-Aircraft")) / "fgvc-aircraft-2013b/data"
        with open(root / "variants.txt") as f:
            self.classes = [line.strip() for line in f if line.strip()]
        class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.image_files, self.labels = [], []
        with open(root / f"images_variant_{split}.txt") as f:
            for line in f:
                image_id, variant = line.strip().split(" ", 1)
                self.image_files.append(str(root / "images" / f"{image_id}.jpg"))
                self.labels.append(class_to_idx[variant])


class CUBFiles(_Files):
    """CUB-200-2011 with the repo's val carve-out (fgvc/datasets/cub_dataset.py:18-89)."""

    dataset_name = "cub"

    def __init__(self, root: Optional[str] = None, split: str = "train"):
        root = Path(root or (data_root() / "CUB/CUB_200_2011"))
        image_path, image_label = {}, {}
        with open(root / "images.txt") as f:
            for line in f:
                i, p = line.strip().split(" ")
                image_path[i] = str(root / "images" / p)
        with open(root / "image_class_labels.txt") as f:
            for line in f:
                i, lab = line.strip().split(" ")
                image_label[i] = int(lab) - 1
        self.image_files, self.labels = [], []
        with open(root / "train_test_split.txt") as f:
            for line in f:
                i, is_train = line.strip().split(" ")
                if int(is_train) if split in ("train", "val") else not int(is_train):
                    self.image_files.append(image_path[i])
                    self.labels.append(image_label[i])
        if split in ("train", "val"):
            self.image_files, self.labels = _val_carve_out(self.image_files, self.labels, split, "cub_val.txt", 2)
        self.classes = [str(i) for i in range(200)]


class StanfordCarsFiles(_Files):
    """Stanford Cars via the devkit .mat annotations + cars_val.txt carve-out."""

    dataset_name = "cars"

    def __init__(self, root: Optional[str] = None, split: str = "train"):
        import scipy.io as sio

        root = Path(root or (data_root() / "stanford_cars")) / "stanford_cars"
        devkit = root / "devkit"
        self.classes = [str(c[0]) for c in sio.loadmat(devkit / "cars_meta.mat")["class_names"][0]]
        if split == "test":
            annos_path = root / "cars_test_annos_withlabels.mat"
            if not annos_path.exists():
                # the devkit's cars_test_annos.mat has no class field
                raise FileNotFoundError(f"{annos_path} is required for the cars test split "
                                        "(the devkit cars_test_annos.mat carries no class labels)")
            images_dir = root / "cars_test"
        else:
            annos_path = devkit / "cars_train_annos.mat"
            images_dir = root / "cars_train"
        self.image_files, self.labels = [], []
        for ann in sio.loadmat(annos_path)["annotations"][0]:
            if len(ann) < 6:
                raise ValueError(f"annotation in {annos_path} lacks a class field")
            self.image_files.append(str(images_dir / str(ann[-1][0])))
            self.labels.append(int(ann[4][0][0]) - 1)
        if split in ("train", "val"):
            self.image_files, self.labels = _val_carve_out(self.image_files, self.labels, split, "cars_val.txt", 1)


class DTDFiles(_Files):
    """DTD partition-1 splits (labels/{split}1.txt)."""

    dataset_name = "dtd"

    def __init__(self, root: Optional[str] = None, split: str = "train", partition: int = 1):
        root = Path(root or (data_root() / "DTD/dtdataset/dtd"))
        images = root / "images"
        self.classes = sorted(p.name for p in images.iterdir() if p.is_dir())
        class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.image_files, self.labels = [], []
        with open(root / "labels" / f"{split}{partition}.txt") as f:
            for line in f:
                rel = line.strip()
                if rel:
                    self.image_files.append(str(images / rel))
                    self.labels.append(class_to_idx[rel.split("/")[0]])


class CompCarsFiles(_Files):
    """CompCars parts from the shipped csv splits (fgvc/datasets/compcars_dataset.py:19-90).
    Label ids come from the split's own csv, sorted, as in the reference."""

    dataset_name = "compcars"

    def __init__(self, root: Optional[str] = None, split: str = "train", dataset_type: str = "parts"):
        if dataset_type != "parts":
            raise ValueError(f"only the parts dataset is read, not {dataset_type!r}")
        root = Path(root or (data_root() / "compcars/part"))
        split_to_load = "train" if split == "val" else split
        files, raw_labels = [], []
        with open(DATASETS_FILES / "compcars-parts" / f"{split_to_load}.csv") as f:
            for line in f:
                path, label = line.strip().split(",")
                files.append(str(root / path))
                raw_labels.append(label)
        label_map = {lab: i for i, lab in enumerate(sorted(set(raw_labels)))}
        self.label_to_class_id_map = label_map
        self.image_files = files
        self.labels = [label_map[lab] for lab in raw_labels]
        if split in ("train", "val"):
            self.image_files, self.labels = _val_carve_out(self.image_files, self.labels, split,
                                                           "compcars_parts_val.txt", 5)
        self.classes = sorted(label_map, key=label_map.get)


class PlanesBiasedFiles(_Files):
    """ALIA contextual-bias planes split (2 classes, airbus/boeing)."""

    dataset_name = "planes-biased"

    def __init__(self, root: Optional[str] = None, split: str = "train"):
        root = Path(root or (data_root() / "FGVC-Aircraft"))
        images_path = root / "fgvc-aircraft-2013b/data/images"
        with open(DATASETS_FILES / "aircraft_biased_dataset/alia_cotextual_bias_split.csv", newline="") as f:
            rows = list(csv.DictReader(f))
        if split in ("train", "test"):
            rows = [r for r in rows if r["Split"] == split]
        elif split == "val":
            rows = [r for r in rows if r["Split"] == "val"][::2]
        elif split == "extra":
            rows = [r for r in rows if r["Split"] == "val"][1::2]
        self.rows = rows
        self.image_files = [str(images_path / Path(r["Filename"]).name) for r in rows]
        self.labels = [int(r["Label"]) for r in rows]
        self.classes = ["airbus", "boeing"]


FILES_REGISTRY = {
    "planes": FGVCAircraftFiles,
    "cub": CUBFiles,
    "cars": StanfordCarsFiles,
    "dtd": DTDFiles,
    "compcars-parts": CompCarsFiles,
    "planes_biased": PlanesBiasedFiles,
}


class AugSampler:
    """Stochastic original -> augmented path substitution
    (fgvc/datasets/aug_wrapper_dataset.py:106-171):
      * aug-JSON keys are original file names; values are cut to
        limit_aug_per_image and empty values dropped;
      * with probability aug_sample_ratio a random aug path, else the original;
      * a warning when the observed swap rate falls below ratio / 3;
      * `stop_aug` turns substitution off (stop_aug_after_epoch)."""

    def __init__(self, aug_json: str, aug_sample_ratio: float, limit_aug_per_image: Optional[int] = None,
                 seed: int = 1, print_func=logging.info):
        if not 0 < aug_sample_ratio <= 1:
            raise ValueError(f"aug_sample_ratio must be in (0, 1], got {aug_sample_ratio}")
        with open(aug_json) as f:
            mapping = json.load(f)
        mapping = {k: v[:limit_aug_per_image] for k, v in mapping.items() if v}
        if not mapping:
            raise ValueError(f"{aug_json}: the aug_json is empty")
        self.aug_json = mapping
        self.aug_sample_ratio = aug_sample_ratio
        self.stop_aug = False
        self.times_used_orig_images = 0
        self.times_used_aug_images = 0
        self.print_func = print_func
        self._rng = pyrandom.Random(seed)

    def __call__(self, image_path: str, idx: int = 0) -> str:
        if self.stop_aug:
            return image_path
        out = image_path
        if self._rng.random() < self.aug_sample_ratio:
            out = self._rng.choice(self.aug_json.get(Path(image_path).name, [image_path]) or [image_path])
        if out != image_path:
            self.times_used_aug_images += 1
        else:
            self.times_used_orig_images += 1
        ratio_used = self.times_used_aug_images / (self.times_used_aug_images + self.times_used_orig_images)
        if idx % 100 == 0 and idx > 99 and ratio_used < self.aug_sample_ratio / 3:
            warnings.warn(f"Using augmented images might be lacking, ratio: {ratio_used:.4f} when it "
                          f"should be around {self.aug_sample_ratio}.")
        return out


class FGVCDataset:
    """A split's file list with AugWrapper's behaviours; item_path(i) ->
    (path, label), the path substituted by the AugSampler on train."""

    def __init__(self, files: _Files, split: str = "train", train_sample_ratio: float = 1.0,
                 aug_json: Optional[str] = None, aug_sample_ratio: Optional[float] = None,
                 limit_aug_per_image: Optional[int] = None, few_shot: Optional[int] = None, seed: int = 1,
                 print_func=logging.info):
        if few_shot and train_sample_ratio < 1:
            raise ValueError("few_shot and train_sample_ratio < 1 exclude each other")
        self.files = files
        self.split = split
        self.is_train = "train" in split
        self.num_classes = files.num_classes
        self.dataset_name = files.dataset_name
        self._image_files = list(files.image_files)
        self._labels = list(files.labels)
        self.print_func = print_func
        self.seed = seed
        if self.is_train and train_sample_ratio < 1:
            self._use_subset(train_sample_ratio)
        if self.is_train and few_shot:
            self._use_few_shot(few_shot)
        print_func(f"DATASET: {self.dataset_name}, SPLIT: {split}")
        print_func(f"LEN DATASET: {len(self._image_files)}")
        print_func(f"NUM CLASSES: {self.num_classes}")

        self.aug_sampler: Optional[AugSampler] = None
        if self.is_train and aug_json and aug_sample_ratio and aug_sample_ratio > 0:
            self.aug_sampler = AugSampler(aug_json, aug_sample_ratio, limit_aug_per_image, seed=seed,
                                          print_func=print_func)
            if aug_sample_ratio == 1:  # drop originals without augmentations (aug_wrapper_dataset.py:126-133)
                names = set(Path(p).name for p in self.aug_sampler.aug_json)
                keep = [i for i, p in enumerate(self._image_files) if Path(p).name in names]
                before = len(self._image_files)
                self._image_files = [self._image_files[i] for i in keep]
                self._labels = [self._labels[i] for i in keep]
                print_func(f"Using only images with augs: {len(keep)} of {before}")
            print_func(f"Using augmented images with ratio {aug_sample_ratio}")
        else:
            print_func("Not using DiffusionAug images")

    @property
    def stop_aug(self) -> bool:
        return self.aug_sampler.stop_aug if self.aug_sampler else True

    @stop_aug.setter
    def stop_aug(self, value: bool):
        if self.aug_sampler:
            self.aug_sampler.stop_aug = value

    def _use_subset(self, ratio: float):
        n = int(len(self._image_files) * ratio)
        idx = np.random.RandomState(self.seed).choice(len(self._image_files), n, replace=False)
        self.print_func(f"With ratio {ratio}, using {n}/{len(self._image_files)} train images")
        self._image_files = [self._image_files[i] for i in idx]
        self._labels = [self._labels[i] for i in idx]

    def _use_few_shot(self, k: int):
        by_label: dict = {}
        for p, lab in zip(self._image_files, self._labels):
            by_label.setdefault(lab, []).append(p)
        files, labels = [], []
        for lab, paths in by_label.items():
            taken = paths[:k]
            files += taken
            labels += [lab] * len(taken)
        short = {lab: len(p) for lab, p in by_label.items() if len(p) < k}
        if len(files) != self.num_classes * k:  # the reference asserts k images a class
            raise ValueError(f"few_shot={k} needs {k} train images per class; short classes "
                             f"(label -> available): {short}")
        self._image_files, self._labels = files, labels
        self.print_func(f"Few-shot: {len(files)} images ({k}/class)")

    def __len__(self):
        return len(self._image_files)

    @property
    def labels(self) -> List[int]:
        return list(self._labels)

    def item_path(self, idx: int) -> Tuple[str, int]:
        path, label = str(self._image_files[idx]), int(self._labels[idx])
        if self.is_train and self.aug_sampler is not None:
            path = self.aug_sampler(path, idx)
        return path, label


def get_datasets(dataset: str, resize: Tuple[int, int] = (224, 224), train_sample_ratio: float = 1.0,
                 aug_json: Optional[str] = None, aug_sample_ratio: Optional[float] = None,
                 limit_aug_per_image: Optional[int] = None, special_aug: Optional[str] = None,
                 use_cutmix: bool = False, few_shot: Optional[int] = None, seed: int = 1, print_func=logging.info):
    """(train, val, test, info) as fgvc/datasets/__init__.py:23-55 builds
    them; info carries the train transform, the cutmix flag, the class
    count and the label-ordered class names."""
    if special_aug is not None:
        special_aug = special_aug.lower()
    if special_aug is not None and "-" in special_aug:
        special_aug, cutmix_aug = special_aug.split("-")
        if cutmix_aug != "cutmix":
            raise ValueError(f"Unsupported cutmix augmentation {cutmix_aug}")
        use_cutmix = True
    if special_aug == "cutmix":  # CutMix over the center crop (fgvc/util.py:301-309)
        use_cutmix = True
        special_aug = None
    if special_aug not in (None, "classic", "classic_no_color", "randaug", "autoaug"):
        raise ValueError(f"unknown special_aug {special_aug!r}; expected one of classic / classic_no_color / "
                         f"randaug / autoaug / cutmix or a '-cutmix' combo (fgvc/util.py:255-315)")
    if dataset not in FILES_REGISTRY:
        raise ValueError(f"Unsupported dataset {dataset}")
    cls = FILES_REGISTRY[dataset]

    def make(split, **kw):
        return FGVCDataset(cls(split=split), split=split, seed=seed, print_func=print_func, **kw)

    train = make("train", train_sample_ratio=train_sample_ratio, aug_json=aug_json,
                 aug_sample_ratio=aug_sample_ratio, limit_aug_per_image=limit_aug_per_image, few_shot=few_shot)
    val = make("val")
    test = make("test")
    info = {"train_transform": special_aug, "resize": resize, "use_cutmix": use_cutmix,
            "num_classes": train.num_classes, "classes": list(train.files.classes)}
    return train, val, test, info
