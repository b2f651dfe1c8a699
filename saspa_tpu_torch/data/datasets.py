"""Dataset annotation readers (counterpart of the file-list providers of
saspa_tpu/data/datasets.py).

Each of the six datasets becomes a list of image files and integer labels,
parsed from its annotation files with the JAX package's split semantics (the
val carve-outs from datasets_files/*.txt).  The roots default to
$SASPA_DATA_ROOT, read when a reader is constructed.  The planes-biased csv
is read with the csv module (the machine with the card has no pandas).  The
training-side `FGVCDataset`, `AugSampler` and pipeline come with the train
slice (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import List, Optional

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
