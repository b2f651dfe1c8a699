"""Per-dataset metadata registry, generation side (counterpart of
saspa_tpu/data/registry.py).

Pure Python: original train paths, class lists, image -> class dicts, basic
prompts, meta classes, same-class sampling and the val carve-outs, with the
reference's filesystem contracts (dataset roots under $SASPA_DATA_ROOT,
split-file formats, the repo's datasets_files/).  $SASPA_DATA_ROOT is read
when a dataset is constructed.  The biased-planes split is read with the
csv module (the machine with the card has no pandas).  A missing dataset
raises (the reference downloads it).  The filter stage's baseline
classifier (`load_baseline_model`: the released .pth from the weights dir
or under $SASPA_CHECKPOINTS/<dataset>, default <repo>/checkpoints) and its
ALIA thresholds live here too; the class ids come from `data.datasets`.
"""

from __future__ import annotations

import csv
import glob
import json
import os
from pathlib import Path
from typing import Dict, List, Optional

REPO_ROOT = Path(__file__).resolve().parent.parent.parent
DATASETS_FILES = REPO_ROOT / "datasets_files"


def data_root() -> Path:
    return Path(os.environ.get("SASPA_DATA_ROOT", "data"))


def checkpoints_dir() -> Path:
    return Path(os.environ.get("SASPA_CHECKPOINTS", str(REPO_ROOT / "checkpoints")))


def load_kv_file(file_path) -> Dict[str, str]:
    """'<id> <info...>' lines -> dict (all_utils/utils.py:615-621)."""
    data = {}
    with open(file_path, "r") as f:
        for line in f:
            image_id, info = line.strip().split(" ", 1)
            data[image_id] = info
    return data


class BaseUtils:
    name: str = ""
    meta_class: str = ""

    def __init__(self, split: str = "train", root_path: str = "", print_func=print):
        self.root_path = Path(root_path)
        self.split = split
        self.print_func = print_func
        self.original_images_paths: List[str] = []
        self.image_path_to_class_str_dict: Dict[str, str] = {}
        # the reference downloads a missing dataset here
        # (all_utils/dataset_utils.py:164-177); the port reads local trees only
        if self.name and str(root_path) and not self.root_path.exists():
            raise FileNotFoundError(f"{self.name}: no dataset at {self.root_path} "
                                    "(set SASPA_DATA_ROOT; the port does not download datasets)")

    # ---- interface -------------------------------------------------------
    def get_classes(self) -> List[str]:
        raise NotImplementedError

    @property
    def num_classes(self) -> int:
        return len(self.get_classes())

    def get_image_path_to_class_str_dict(self) -> Dict[str, str]:
        raise NotImplementedError

    def get_image_stem_to_class_str_dict(self) -> Dict[str, str]:
        raise NotImplementedError

    def get_image_path_to_class_id_dict(self, split: str = "train") -> Dict[str, int]:
        raise NotImplementedError

    def get_basic_prompt(self) -> str:
        raise NotImplementedError

    def get_image_path_with_same_class(self, image_path: str) -> List[str]:
        """Same-class image paths (all_utils/dataset_utils.py:67-76); the
        class -> keys index is built once."""
        key = Path(image_path).stem if self.name in ("planes", "cars") else image_path
        class_str = self.image_path_to_class_str_dict[key]
        if not hasattr(self, "_class_to_keys"):
            idx: Dict[str, List[str]] = {}
            for p, c in self.image_path_to_class_str_dict.items():
                idx.setdefault(c, []).append(p)
            self._class_to_keys = idx
        same = self._class_to_keys[class_str]
        if self.name in ("planes", "cars"):
            same = [str(self.images_folder / f"{p}.jpg") for p in same]
        return same

    # ---- shared helpers ---------------------------------------------------
    def _val_split_filter(self, split: str, paths: List[str], dataset_name: str, match="name") -> List[str]:
        """Carve a val split out of train using datasets_files/<ds>_val.txt
        (all_utils/dataset_utils.py:148-162)."""
        with open(DATASETS_FILES / f"{dataset_name}_val.txt") as f:
            val_files = set(line.strip() for line in f)

        def key(p):
            if match == "name":
                return Path(p).name
            if match == "full":
                return p
            raise ValueError(match)

        if split == "val":
            return [p for p in paths if key(p) in val_files]
        return [p for p in paths if key(p) not in val_files]

    def load_baseline_model(self, resize=(224, 224), device=None, weights_dir=None):
        """The dataset's WSDAN_CAL baseline for confidence filtering
        (all_utils/dataset_utils.py:87-115): (model, preprocess_fn)."""
        from saspa_tpu_torch.filters.confidence import load_cal_baseline

        name = "compcars" if "compcars" in self.name else self.name
        return load_cal_baseline(name, self.num_classes, resize=resize, device=device, weights_dir=weights_dir)

    def get_baseline_conf_threshold(self, device=None, weights_dir=None) -> Dict[str, float]:
        """Per-class mean-confidence thresholds for ALIA filtering, computed
        once and cached in alia_confidence_thresholds/<name>.json under the
        working directory (all_utils/dataset_utils.py:117-146)."""
        json_path = Path(f"alia_confidence_thresholds/{self.name}.json")
        if json_path.exists():
            with open(json_path) as f:
                return json.load(f)
        from saspa_tpu_torch.filters.confidence import compute_alia_thresholds

        thresholds = compute_alia_thresholds(self, device=device, weights_dir=weights_dir)
        json_path.parent.mkdir(parents=True, exist_ok=True)
        with open(json_path, "w") as f:
            json.dump(thresholds, f)
        self.print_func(f"Saved baseline mean confidences to {json_path}")
        return thresholds


def _class_ids(ds) -> Dict[str, int]:
    """image path -> class id of a `data.datasets` reader."""
    return dict(zip(ds.image_files, ds.labels))


class PlanesUtils(BaseUtils):
    name = "planes"
    meta_class = "airplane"

    def __init__(self, split="train", root_path=None, print_func=print):
        root_path = root_path or str(data_root() / "FGVC-Aircraft/fgvc-aircraft-2013b/data")
        super().__init__(split, root_path, print_func)
        self.images_folder = self.root_path / "images"
        self.manufacturers_file_path = self.root_path / f"images_manufacturer_{split}.txt"
        self.variants_file_path = self.root_path / f"images_variant_{split}.txt"
        with open(self.root_path / f"images_{split}.txt") as f:
            self.image_names = f.read().splitlines()
        self.original_images_paths = [str(self.images_folder / f"{n}.jpg") for n in self.image_names]
        self.print_func(f"Loaded {len(self.original_images_paths)} images for planes")
        self.image_path_to_class_str_dict = self.get_image_stem_to_class_str_dict()

    def get_image_stem_to_class_str_dict(self):
        manufacturers = load_kv_file(self.manufacturers_file_path)
        variants = load_kv_file(self.variants_file_path)
        return {i: f"{manufacturers[i]} {variants[i]}" for i in manufacturers if i in variants}

    def get_image_path_to_class_id_dict(self, split="train"):
        from saspa_tpu_torch.data.datasets import FGVCAircraftFiles

        return _class_ids(FGVCAircraftFiles(split=split))

    def get_classes(self):
        return list(set(self.image_path_to_class_str_dict.values()))

    def get_basic_prompt(self):
        return "a photo of an aircraft"


class CarsUtils(BaseUtils):
    name = "cars"
    meta_class = "car"

    def __init__(self, split="train", root_path=None, print_func=print):
        root_path = root_path or str(data_root() / "stanford_cars/stanford_cars")
        super().__init__(split, root_path, print_func)
        assert split in ("train", "val", "test")
        split_to_use = "train" if split == "val" else split
        self.devkit = self.root_path / "devkit"
        self.meta_file_path = self.devkit / "cars_meta.mat"
        self.annots_path = self.devkit / f"cars_{split_to_use}_annos.mat"
        self.images_folder = self.root_path / f"cars_{split_to_use}"
        self.original_images_paths = sorted(glob.glob(f"{self.images_folder}/*.jpg"))
        if split in ("train", "val"):
            self.original_images_paths = self._val_split_filter(split, self.original_images_paths, "cars")
        self.print_func(f"Loaded {len(self.original_images_paths)} images for cars, split {split}")
        self.image_path_to_class_str_dict = self.get_image_stem_to_class_str_dict()

    def get_image_stem_to_class_str_dict(self):
        import scipy.io as sio

        meta = sio.loadmat(self.meta_file_path)["class_names"]
        id_to_name = {i + 1: str(info[0]) for i, info in enumerate(meta[0])}
        out = {}
        for ann in sio.loadmat(self.annots_path)["annotations"][0]:
            image_id = Path(str(ann[-1][0])).stem
            class_id = int(ann[4][0][0])
            if class_id in id_to_name:
                out[image_id] = id_to_name[class_id]
        return out

    def get_image_path_to_class_id_dict(self, split="train"):
        from saspa_tpu_torch.data.datasets import StanfordCarsFiles

        return _class_ids(StanfordCarsFiles(split=split))

    def get_classes(self):
        return list(set(self.get_image_stem_to_class_str_dict().values()))

    def get_basic_prompt(self):
        return "a photo of a car"


class DTDUtils(BaseUtils):
    name = "dtd"
    meta_class = "texture"

    def __init__(self, split="train", partition=1, root_path=None, print_func=print):
        root_path = root_path or str(data_root() / "DTD/dtdataset/dtd")
        super().__init__(split, root_path, print_func)
        self.images_folder = self.root_path / "images"
        self.all_original_images_paths = sorted(glob.glob(f"{self.images_folder}/*/*.jpg"))
        with open(self.root_path / "labels" / f"{split}{partition}.txt") as f:
            names = f.read().splitlines()
        self.original_images_paths = [str(self.images_folder / n) for n in names]
        self.print_func(
            f"Loaded {len(self.original_images_paths)} images for DTD split {split} partition {partition}"
        )
        self.image_path_to_class_str_dict = self.get_image_path_to_class_str_dict()

    def get_classes(self):
        return sorted(os.listdir(self.images_folder))

    def get_image_path_to_class_str_dict(self):
        return {p: Path(p).parent.name for p in self.all_original_images_paths}

    def get_image_path_to_class_id_dict(self, split="train"):
        """Every split's ids: the reference reads all three."""
        from saspa_tpu_torch.data.datasets import DTDFiles

        out = {}
        for s in ("train", "val", "test"):
            out.update(_class_ids(DTDFiles(split=s)))
        return out

    def get_basic_prompt(self):
        return "a photo of a texture"


class CompCarsPartsUtils(BaseUtils):
    name = "compcars-parts"
    meta_class = "car"
    part_to_string = {
        "1": "Headlight",
        "2": "Taillight",
        "3": "Fog light",
        "4": "front",
    }

    def __init__(self, split="train", root_path=None, print_func=print):
        root_path = root_path or str(data_root() / "compcars")
        super().__init__(split, root_path, print_func)
        assert split in ("train", "val", "test")
        split_to_use = "train" if split == "val" else split
        self.images_folder = self.root_path / "part"

        make_model = self._load_make_model_names()
        self.full_folder_path_to_make_model = {}
        for folder in glob.glob(f"{self.images_folder}/*/*"):
            make_idx, model_idx = int(folder.split("/")[-2]), int(folder.split("/")[-1])
            self.full_folder_path_to_make_model[folder] = (
                f"{make_model['makes'].get(make_idx, '')} {make_model['models'].get(model_idx, '')}"
            )

        split_csv = DATASETS_FILES / "compcars-parts" / f"{split_to_use}.csv"
        all_csv = DATASETS_FILES / "compcars-parts" / "train_and_test.csv"
        self.original_images_paths = [
            str(self.images_folder / line.split(",")[0]) for line in open(split_csv).read().splitlines()
        ]
        rows = [line.split(",") for line in open(all_csv).read().splitlines()]
        self.all_original_images_paths = [str(self.images_folder / r[0]) for r in rows]
        self.all_classes = sorted(set(r[1] for r in rows))

        if split in ("train", "val"):
            self.original_images_paths = self._val_split_filter(
                split, self.original_images_paths, "compcars_parts", match="tail5"
            )
        # derived from this split's post-carve-out paths, as the reference
        # does (all_utils/dataset_utils.py:394-395); sorted for determinism
        self.all_classes_as_strings = sorted(
            set(
                self.full_folder_path_to_make_model.get(str(Path(p).parent.parent.parent), "")
                for p in self.original_images_paths
            )
        )
        self.print_func(f"Loaded {len(self.original_images_paths)} compcars-parts images, split {split}")
        self.image_path_to_class_str_dict = self.get_image_path_to_class_str_dict()

    def _load_make_model_names(self):
        import scipy.io as sio

        mat_path = self.root_path / "misc/make_model_name.mat"
        if not mat_path.exists():
            raise FileNotFoundError(
                f"{mat_path} is required for compcars-parts class names "
                "(ships inside the CompCars misc/ folder)"
            )
        mat = sio.loadmat(mat_path)

        def clean(arr):
            out = {}
            for i, x in enumerate(arr):
                v = x[0]
                out[i + 1] = str(v.item() if hasattr(v, "item") and getattr(v, "size", 1) == 1 else v) \
                    if getattr(v, "size", 1) else ""
            return out

        return {"makes": clean(mat["make_names"]), "models": clean(mat["model_names"])}

    def _val_split_filter(self, split, paths, dataset_name, match="tail5"):
        with open(DATASETS_FILES / f"{dataset_name}_val.txt") as f:
            val_files = set(line.strip() for line in f)

        def key(p):
            return str(Path(*Path(p).parts[-5:]))

        if split == "val":
            return [p for p in paths if key(p) in val_files]
        return [p for p in paths if key(p) not in val_files]

    def get_classes(self):
        return self.all_classes_as_strings

    def get_image_path_to_class_str_dict(self):
        return {
            p: self.full_folder_path_to_make_model.get(str(Path(p).parent.parent.parent), "")
            for p in self.all_original_images_paths
        }

    def get_image_path_to_class_id_dict(self, split="train"):
        """Ids from the split's own csv, sorted, without the val carve-out."""
        files, labels = [], []
        with open(DATASETS_FILES / "compcars-parts" / f"{split}.csv") as f:
            for line in f.read().splitlines():
                path, label = line.strip().split(",")
                files.append(str(self.images_folder / path))
                labels.append(label)
        label_map = {lab: i for i, lab in enumerate(sorted(set(labels)))}
        return {f: label_map[lab] for f, lab in zip(files, labels)}

    def get_basic_prompt(self, part: Optional[str] = None):
        if part:
            return f"close up of the {self.part_to_string[str(part)]} of a"
        return "close up of a car"

    def get_image_path_with_same_class(self, image_path: str):
        """Same class and same car part (all_utils/dataset_utils.py:439-444)."""
        class_str = self.image_path_to_class_str_dict[image_path]
        part = image_path.split("/")[-2]
        return [
            p for p, c in self.image_path_to_class_str_dict.items() if c == class_str and p.split("/")[-2] == part
        ]


def _cub_train_files(root: Path, split: str) -> List[str]:
    """CUB-200-2011 image paths of a split with the repo's val carve-out
    (fgvc/datasets/cub_dataset.py:18-89; the JAX package's CUBFiles)."""
    image_path = {}
    with open(root / "images.txt") as f:
        for line in f:
            i, p = line.strip().split(" ")
            image_path[i] = str(root / "images" / p)
    files = []
    with open(root / "train_test_split.txt") as f:
        for line in f:
            i, is_train = line.strip().split(" ")
            if (int(is_train) if split in ("train", "val") else not int(is_train)):
                files.append(image_path[i])
    if split in ("train", "val"):
        with open(DATASETS_FILES / "cub_val.txt") as f:
            val_files = set(line.strip() for line in f)
        files = [p for p in files if (split == "val") == (str(Path(*Path(p).parts[-2:])) in val_files)]
    return files


class CUBUtils(BaseUtils):
    name = "cub"
    meta_class = "bird"

    def __init__(self, split="train", root_path=None, print_func=print):
        root_path = root_path or str(data_root() / "CUB/CUB_200_2011")
        super().__init__(split, root_path, print_func)
        self.images_folder = self.root_path / "images"
        self.original_images_paths = _cub_train_files(self.root_path, split)
        self.print_func(f"Loaded {len(self.original_images_paths)} images for CUB")
        self.image_path_to_class_str_dict = self.get_image_path_to_class_str_dict()

    def get_image_path_to_class_str_dict(self):
        id_to_name = {}
        with open(self.root_path / "classes.txt") as f:
            for line in f:
                cid, cname = line.strip().split(" ", 1)
                id_to_name[int(cid) - 1] = cname.split(".", 1)[1]
        return {p: id_to_name[int(Path(p).parent.name.split(".")[0]) - 1] for p in self.original_images_paths}

    def get_image_path_to_class_id_dict(self, split="train"):
        from saspa_tpu_torch.data.datasets import CUBFiles

        return _class_ids(CUBFiles(split=split, root=str(self.root_path)))

    def get_classes(self):
        return list(set(self.image_path_to_class_str_dict.values()))

    def get_basic_prompt(self):
        return "a photo of a bird"


class PlanesBiasedUtils(BaseUtils):
    name = "planes"  # the reference keeps name='planes' (all_utils/dataset_utils.py:493)
    meta_class = "airplane"

    def __init__(self, split="train", root_path=None, print_func=print):
        root_path = root_path or str(data_root() / "FGVC-Aircraft/fgvc-aircraft-2013b/data")
        super().__init__(split, root_path, print_func)
        self.images_folder = self.root_path / "images"
        # 'extra' rows are carved from the csv's val rows and FGVC-Aircraft
        # ships no images_*_extra.txt: the val annotation files cover them
        ann_split = "val" if split == "extra" else split
        self.manufacturers_file_path = self.root_path / f"images_manufacturer_{ann_split}.txt"
        self.variants_file_path = self.root_path / f"images_variant_{ann_split}.txt"

        with open(DATASETS_FILES / "aircraft_biased_dataset/alia_cotextual_bias_split.csv", newline="") as f:
            rows = list(csv.DictReader(f))
        # split slicing rules (all_utils/dataset_utils.py:505-512)
        if split in ("train", "test"):
            rows = [r for r in rows if r["Split"] == split]
        elif split == "val":
            rows = [r for r in rows if r["Split"] == "val"][::2]
        elif split == "extra":
            rows = [r for r in rows if r["Split"] == "val"][1::2]
        self.rows = rows
        self.image_names = [Path(r["Filename"]).stem for r in rows]
        self.original_images_paths = [str(self.images_folder / f"{n}.jpg") for n in self.image_names]
        self.print_func(f"Loaded {len(self.original_images_paths)} images for planes biased {split}")
        self.image_path_to_class_str_dict = self.get_image_stem_to_class_str_dict()

    def get_image_stem_to_class_str_dict(self):
        manufacturers = load_kv_file(self.manufacturers_file_path)
        variants = load_kv_file(self.variants_file_path)
        return {i: f"{manufacturers[i]} {variants[i]}" for i in manufacturers if i in variants}

    def get_image_path_to_class_id_dict(self, split="train"):
        from saspa_tpu_torch.data.datasets import PlanesBiasedFiles

        return _class_ids(PlanesBiasedFiles(split=split))

    def get_classes(self):
        return list(set(self.image_path_to_class_str_dict.values()))

    def get_basic_prompt(self):
        return "a photo of an aircraft"


DS_UTILS_DICT = {
    "planes": PlanesUtils,
    "cars": CarsUtils,
    "dtd": DTDUtils,
    "compcars-parts": CompCarsPartsUtils,
    "cub": CUBUtils,
    "planes_biased": PlanesBiasedUtils,
}
