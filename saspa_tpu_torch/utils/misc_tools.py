"""Small host utilities from the reference's all_utils/utils.py
(counterpart of saspa_tpu/utils/misc_tools.py): same-class id sampling
(with the cars front/back matching through the VQA captions), deleting
files by substring, and the folder -> augmented paths dict.  The debug grid
`plot_images_in_row` needs matplotlib, which the card's machine lacks, and
raises.
"""

from __future__ import annotations

import logging
import os
import random as pyrandom
from pathlib import Path
from typing import Dict, List, Optional

CAR_DIRECTION_QUESTION = "is the back or front of the car shown?"


def get_same_class_image_names(
    dataset: str = "planes",
    num_per_image: int = 1,
    same_car_direction: bool = False,
    captions_dict: Optional[dict] = None,
    split: str = "train",
    random_class: bool = False,
    seed: int = 0,
) -> Dict[str, List[str]]:
    """id -> [ids of the same class] (all_utils/utils.py:624-678); for cars,
    optionally of the same front/back direction too, read from the VQA
    captions' CAR_DIRECTION_QUESTION answers."""
    from saspa_tpu_torch.data.registry import CarsUtils, PlanesUtils

    rng = pyrandom.Random(seed)
    if dataset == "planes":
        utils = PlanesUtils(split=split)
    elif dataset == "cars":
        if same_car_direction:
            assert captions_dict is not None, "same_car_direction needs captions"
        utils = CarsUtils(split=split)
    else:
        raise NotImplementedError(dataset)

    stem_to_class = utils.get_image_stem_to_class_str_dict()
    direction = {}
    if dataset == "cars" and same_car_direction:
        for path, entry in captions_dict.items():
            direction[Path(path).stem] = entry.get(CAR_DIRECTION_QUESTION)

    def key_of(i):
        key = ("*",) if random_class else (stem_to_class[i],)
        return key + (direction.get(i),) if direction else key

    by_key: Dict[tuple, List[str]] = {}
    for i in stem_to_class:
        by_key.setdefault(key_of(i), []).append(i)
    out = {}
    for i in stem_to_class:
        pool = by_key[key_of(i)]
        if len(pool) < num_per_image:
            logging.info("not enough images for id %s, taking all %d", i, len(pool))
            out[i] = list(pool)
        else:
            out[i] = rng.sample(pool, num_per_image)
    return out


def delete_files_in_folder_with_substr(folder_path, substr, max_num_files_to_delete=300) -> int:
    """all_utils/utils.py:514-524."""
    num_deleted = 0
    for name in os.listdir(folder_path):
        if substr in name:
            os.remove(os.path.join(folder_path, name))
            num_deleted += 1
            if num_deleted >= max_num_files_to_delete:
                logging.info("reached max_num_files_to_delete=%d", max_num_files_to_delete)
                break
    logging.info("deleted %d files in %s with substr %s", num_deleted, folder_path, substr)
    return num_deleted


def create_dict_image_path_to_augmented_images_paths(aug_data_folder, original_images_paths) -> Dict[str, List[str]]:
    """all_utils/utils.py:527-534 (unfiltered stem-substring matching)."""
    names = os.listdir(aug_data_folder)
    out = {}
    for image_path in original_images_paths:
        stem = Path(image_path).stem
        out[image_path] = [str(Path(aug_data_folder) / n) for n in names if stem in n and "_source" not in n]
    return out


def plot_images_in_row(images_list, titles=None):
    """The debug grid of all_utils/utils.py:562-573: not ported."""
    raise NotImplementedError("plot_images_in_row needs matplotlib (the plots are not ported; ROADMAP Queue 1 "
                              "item 11 [11b])")
