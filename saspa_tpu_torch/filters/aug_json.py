"""Aug-JSON artifact: builder, naming, merge/edit tools (counterpart of
saspa_tpu/filters/aug_json.py).

Artifact contract (byte-compatible with the reference):
  * JSON maps original image *file name* -> list of surviving aug paths
    (all_utils/utils.py:442-443)
  * json filename encodes the filter configuration (get_aug_json_path,
    all_utils/utils.py:194-218)
  * matching rule: first 40 chars of the original stem must be a substring of
    the aug filename (all_utils/utils.py:342-354); side files excluded by
    substring (:246)

The filter sweep itself is batched: all aug images are scored in padded
batches on the card (CLIP features and CAL logits computed once), then the
keep/drop predicates run on the host in the reference's order with the
reference's counters.  Files are checked with `gen.image_io.verify_image`
(PIL's verify, without PIL for PNG and JPEG).  The LPIPS filter
(lpips_min <= d <= lpips_max) scores each aug against its original in
padded batches (filters/lpips_filter.py), after the confidence filter and
before CLIP, in the JAX builder's order.

With a mesh of more than one rank (`cli filter` under torchrun), every rank
runs the builder and both scorers split each batch over the ranks
(filters/batches.py).  Rank 0 alone verifies and deletes corrupt files,
before a barrier after which every rank lists the folder; rank 0 alone runs
the host-side filters (LPIPS, the ALIA thresholds), writes the JSON, its log
and the telemetry line, and a last barrier lets every rank return the
JSON's path once it is written.
"""

from __future__ import annotations

import json
import logging
import os
import random as pyrandom
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from saspa_tpu_torch.gen.image_io import CorruptImage, verify_image
from saspa_tpu_torch.utils import rng as rngs
from saspa_tpu_torch.utils.config import MAX_FILENAME_LENGTH as MAX_FILE_NAME_LENGTH

SUBSTRINGS_TO_EXCLUDE = ["_source.", "_style.", "_target.", "_control.", "_original.", "_subject.", "subject_"]


# --------------------------------------------------------------------------
# naming (exact reference strings)
# --------------------------------------------------------------------------
def get_aug_json_path(
    augmented_image_folder_path,
    lpips_min=None,
    lpips_max=None,
    clip_filtering=False,
    clip_filtering_discount=1,
    semantic_filtering=False,
    model_confidence_based_filtering=False,
    conf_top_k: int = 10,
    filter_confidence_higher_than=None,
    alia_conf_filtering=False,
) -> str:
    json_name = ""
    if lpips_min:
        json_name += f"lpips_min_{lpips_min}-"
    if lpips_max:
        json_name += f"lpips_max_{lpips_max}-"
    if clip_filtering:
        json_name += f"clip_filtering_{clip_filtering}_discount_{clip_filtering_discount}-"
    if semantic_filtering:
        json_name += "semantic_filtering-"
    if model_confidence_based_filtering:
        json_name += f"model_confidence_based_filtering_top_{conf_top_k}_classes-"
        if filter_confidence_higher_than:
            json_name += f"filter_confidence_higher_than_{filter_confidence_higher_than}-"
    if alia_conf_filtering:
        json_name += "alia_conf_filtering-"
    json_name += "aug.json"
    return str(Path(augmented_image_folder_path).parent / json_name)


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------
def check_folder_of_images_with_pil(folder, max_delete=20, substrings_to_exclude=None):
    """Verify every image as PIL's verify() does; delete corrupt ones up to
    max_delete (all_utils/utils.py:681-703).  A file that cannot be checked
    here (RuntimeError from verify_image) stops the run and is kept."""
    num_deleted = 0
    names = [
        n for n in os.listdir(folder)
        if not any(s in n for s in (substrings_to_exclude or []))
    ]
    for name in names:
        path = Path(folder) / name
        try:
            verify_image(path)
        except KeyboardInterrupt:
            sys.exit(0)
        except CorruptImage:
            logging.info("image %s is corrupted, deleting", path)
            os.remove(path)
            num_deleted += 1
            if num_deleted >= max_delete:
                logging.info("reached max_delete = %d", max_delete)
                break
    logging.info("PIL check done for %s, deleted %d", folder, num_deleted)


def get_dict_of_value_counts_image_name_to_num_aug_images(mapping, load_the_json=False) -> Dict[int, int]:
    if load_the_json:
        with open(mapping) as f:
            mapping = json.load(f)
    counts: Dict[int, int] = {}
    for _, augs in mapping.items():
        counts[len(augs)] = counts.get(len(augs), 0) + 1
    return counts


def _clip_class_battery(dataset: str, utils_to_use) -> Tuple[List[str], List[str], Dict[str, str], str]:
    """(classnames, prompts, image_key->class_str dict, key_mode)
    per all_utils/utils.py:277-296."""
    classnames = utils_to_use.get_classes()
    if dataset in ("planes", "planes_biased"):
        prompts = ["a photo of a " + n + ", a type of aircraft." for n in classnames]
        return classnames, prompts, utils_to_use.get_image_stem_to_class_str_dict(), "stem"
    if dataset == "cars":
        prompts = ["a photo of a " + n + ", a type of car." for n in classnames]
        return classnames, prompts, utils_to_use.get_image_stem_to_class_str_dict(), "stem"
    if dataset == "dtd":
        prompts = ["a photo of a " + n + ", a type of texture." for n in classnames]
        return classnames, prompts, utils_to_use.get_image_path_to_class_str_dict(), "path"
    if dataset == "compcars-parts":
        classnames = sorted(set(utils_to_use.part_to_string.values()))
        prompts = ["a photo of the " + n + ", of a car." for n in classnames]
        d = {p: utils_to_use.part_to_string[Path(p).parent.name] for p in utils_to_use.all_original_images_paths}
        return classnames, prompts, d, "path"
    if dataset == "cub":
        prompts = ["a photo of a " + n + ", a type of a bird." for n in classnames]
        return classnames, prompts, utils_to_use.get_image_path_to_class_str_dict(), "path"
    raise NotImplementedError(dataset)


# --------------------------------------------------------------------------
# the builder
# --------------------------------------------------------------------------
def create_json_of_image_name_to_augmented_images_paths(
    dataset,
    augmented_image_folder_path,
    lpips_min=None,
    lpips_max=None,
    resize: Tuple = (256, 256),
    clip_filtering=False,
    clip_filtering_discount=1,
    semantic_filtering=False,
    model_confidence_based_filtering=False,
    conf_top_k: int = 10,
    filter_confidence_higher_than=None,
    init_log=True,
    alia_conf_filtering=False,
    weights_dir: Optional[str] = None,
    batch_size: int = 64,
    seed: int = 0,
    device=None,
    mesh=None,
) -> str:
    """Writes the aug-JSON of a folder of generated images and returns its
    path.  The models run on `device` (None: the card); `mesh` shares the
    scoring among its ranks (module docstring)."""
    if clip_filtering and model_confidence_based_filtering:
        raise ValueError("can't use both clip_filtering and model_confidence_based_filtering")
    from saspa_tpu_torch.data.registry import DS_UTILS_DICT
    from saspa_tpu_torch.filters.batches import new_timings
    from saspa_tpu_torch.parallel.mesh import barrier

    mesh = mesh if mesh is not None and mesh.size > 1 else None
    lead = mesh is None or mesh.rank == 0

    if not str(augmented_image_folder_path).endswith("/images"):
        augmented_image_folder_path = str(Path(augmented_image_folder_path) / "images")

    json_path = get_aug_json_path(
        augmented_image_folder_path, lpips_min, lpips_max, clip_filtering,
        clip_filtering_discount, semantic_filtering, model_confidence_based_filtering,
        conf_top_k, filter_confidence_higher_than, alia_conf_filtering,
    )
    if init_log and lead:
        from saspa_tpu_torch.utils.logging_utils import init_logging

        init_logging(logfile=json_path.replace(".json", ".log"))
    logging.info("json_path = %s", json_path)

    timings = new_timings()
    t0 = time.perf_counter()
    if lead:
        check_folder_of_images_with_pil(augmented_image_folder_path, max_delete=50,
                                        substrings_to_exclude=SUBSTRINGS_TO_EXCLUDE)
    if mesh is not None:  # the others list the folder once the corrupt files are gone
        barrier(mesh)
    timings["verify_s"] = time.perf_counter() - t0

    utils_to_use = DS_UTILS_DICT[dataset](print_func=logging.info)
    original_images_paths = utils_to_use.original_images_paths

    all_file_names = [
        n for n in os.listdir(augmented_image_folder_path)
        if not any(s in n for s in SUBSTRINGS_TO_EXCLUDE)
    ]

    # ---- match aug files to originals (40-char-stem substring rule) --------
    per_image_augs: List[List[str]] = []
    flat_paths: List[str] = []
    flat_owner: List[int] = []
    for i, image_path in enumerate(original_images_paths):
        stem = Path(image_path).stem[:MAX_FILE_NAME_LENGTH]
        matches = [str(Path(augmented_image_folder_path) / n) for n in all_file_names if stem in n]
        per_image_augs.append(matches)
        for m in matches:
            flat_owner.append(i)
            flat_paths.append(m)
    logging.info("matched %d aug images to %d originals", len(flat_paths), len(original_images_paths))

    # ---- batched scoring passes --------------------------------------------
    keep = np.ones(len(flat_paths), bool)
    counters = {
        "lpips_min": 0, "lpips_max": 0, "clip_filtering": 0, "semantic_filtering": 0,
        f"not_in_top_{conf_top_k}": 0, "too_high_confidence": 0,
        "alia_correct_conf_higher_than": 0, "alia_wrong_conf_higher_than": 0,
    }

    baseline_logits = None
    if model_confidence_based_filtering or alia_conf_filtering:
        model, preprocess = utils_to_use.load_baseline_model(device=device, weights_dir=weights_dir)
        from saspa_tpu_torch.filters.confidence import batched_logits

        baseline_logits = batched_logits(model, flat_paths, preprocess, batch_size, timings, mesh)
        del model
        path_to_class = utils_to_use.get_image_path_to_class_id_dict()
        owner_class = np.asarray(
            [path_to_class[original_images_paths[o]] for o in flat_owner], np.int64
        ) if flat_owner else np.zeros(0, np.int64)

    if model_confidence_based_filtering and len(flat_paths):
        k = min(conf_top_k, utils_to_use.num_classes)
        topk_idx = np.argsort(-baseline_logits, axis=-1)[:, :k]
        in_topk = (topk_idx == owner_class[:, None]).any(axis=-1)
        newly_dropped = keep & ~in_topk
        counters[f"not_in_top_{conf_top_k}"] = int(newly_dropped.sum())
        keep &= in_topk
        if filter_confidence_higher_than:
            ex = np.exp(baseline_logits - baseline_logits.max(-1, keepdims=True))
            probs = ex / ex.sum(-1, keepdims=True)
            conf = probs[np.arange(len(owner_class)), owner_class]
            too_high = conf > filter_confidence_higher_than
            counters["too_high_confidence"] = int((keep & too_high).sum())
            keep &= ~too_high

    if (lpips_min or lpips_max) and len(flat_paths) and lead:
        from saspa_tpu_torch.filters.lpips_filter import batched_lpips

        dists = batched_lpips([original_images_paths[o] for o in flat_owner], flat_paths, resize=resize,
                              weights_dir=weights_dir, batch_size=batch_size, device=device, timings=timings)
        lo = lpips_min if lpips_min is not None else -np.inf
        hi = lpips_max if lpips_max is not None else np.inf
        counters["lpips_min"] = int((keep & (dists < lo)).sum())
        counters["lpips_max"] = int((keep & (dists > hi)).sum())
        keep &= (dists >= lo) & (dists <= hi)

    clip_scorer = None
    if (clip_filtering or semantic_filtering) and len(flat_paths):
        from saspa_tpu_torch.filters.clip_filters import (
            CLIPScorer,
            NEGATIVE_SEMANTIC_PROMPTS,
            per_class_keep,
            semantic_keep,
        )

        clip_scorer = CLIPScorer("rn50", weights_dir=weights_dir, device=device)
        img_feats = clip_scorer.image_features(flat_paths, batch_size, timings, mesh)

    if clip_filtering and len(flat_paths):
        classnames, prompts, key_to_class, key_mode = _clip_class_battery(dataset, utils_to_use)
        txt = clip_scorer.text_features(prompts)
        logits = clip_scorer.logits(img_feats, txt)
        threshold = 1 / len(classnames) / clip_filtering_discount
        logging.info("CLIP filtering threshold = %s", threshold)
        class_idx = []
        for o in flat_owner:
            op = original_images_paths[o]
            key = Path(op).stem.split("_")[0] if key_mode == "stem" else op
            class_idx.append(classnames.index(key_to_class[key]))
        mask = per_class_keep(logits, np.asarray(class_idx), threshold)
        counters["clip_filtering"] = int((keep & ~mask).sum())
        keep &= mask

    if semantic_filtering and len(flat_paths):
        battery = [utils_to_use.get_basic_prompt()] + NEGATIVE_SEMANTIC_PROMPTS
        logging.info("semantic filtering prompts = %s", battery)
        txt = clip_scorer.text_features(battery)
        logits = clip_scorer.logits(img_feats, txt)
        mask = semantic_keep(logits)
        counters["semantic_filtering"] = int((keep & ~mask).sum())
        keep &= mask

    if not lead:  # the scoring's collectives are done; rank 0 filters and writes
        barrier(mesh)
        return json_path

    if alia_conf_filtering and len(flat_paths):
        thresholds = utils_to_use.get_baseline_conf_threshold(device=device, weights_dir=weights_dir)
        max_conf = baseline_logits.max(axis=-1)
        pred = baseline_logits.argmax(axis=-1)
        for j in range(len(flat_paths)):
            if not keep[j]:
                continue
            thr = thresholds[str(int(owner_class[j]))]
            # per-item amnesty coin keyed by the aug filename, so the outcome
            # for a given image is stable across reruns with other filters
            # toggled (a sequential stream would shift with every earlier
            # keep/drop change); reference draws sequential random()
            # (all_utils/utils.py:420) — statistically identical 20% rate
            coin = rngs.host_uniform(seed, "alia_amnesty", Path(flat_paths[j]).name)
            if max_conf[j] > thr and coin > 0.2:  # 20% amnesty
                if pred[j] == owner_class[j]:
                    counters["alia_correct_conf_higher_than"] += 1
                else:
                    counters["alia_wrong_conf_higher_than"] += 1
                keep[j] = False

    # ---- assemble + write ----------------------------------------------------
    result: Dict[str, List[str]] = {}
    cursor = 0
    for i, image_path in enumerate(original_images_paths):
        n = len(per_image_augs[i])
        kept = [p for p, k in zip(flat_paths[cursor : cursor + n], keep[cursor : cursor + n]) if k]
        result[Path(image_path).name] = kept
        cursor += n

    Path(json_path).parent.mkdir(parents=True, exist_ok=True)
    with open(json_path, "w") as f:
        json.dump(result, f)
    logging.info("Finished writing %s", json_path)

    for name, (enabled, count) in {
        "lpips_min": (lpips_min, counters["lpips_min"]),
        "lpips_max": (lpips_max, counters["lpips_max"]),
        "clip_filtering": (clip_filtering, counters["clip_filtering"]),
        "semantic_filtering": (semantic_filtering, counters["semantic_filtering"]),
        f"not_in_top_{conf_top_k}": (model_confidence_based_filtering, counters[f"not_in_top_{conf_top_k}"]),
        "too_high_confidence": (model_confidence_based_filtering, counters["too_high_confidence"]),
        "alia_correct_conf_higher_than": (alia_conf_filtering, counters["alia_correct_conf_higher_than"]),
        "alia_wrong_conf_higher_than": (alia_conf_filtering, counters["alia_wrong_conf_higher_than"]),
    }.items():
        if enabled:
            logging.info("For filter = %s, filtered %d images", name, count)

    logging.info("augs/image histogram: %s", get_dict_of_value_counts_image_name_to_num_aug_images(result))
    logging.info("filter telemetry: %s", json.dumps(timings))
    if mesh is not None:
        barrier(mesh)
    return json_path


# --------------------------------------------------------------------------
# merge / edit tools (all_utils/utils.py:485-511,706-761)
# --------------------------------------------------------------------------
def merge_aug_jsons(list_of_jsons: list, output_json_path: str) -> dict:
    Path(output_json_path).parent.mkdir(parents=True, exist_ok=True)
    merged: Dict[str, List[str]] = {}
    for jp in list_of_jsons:
        with open(jp) as f:
            d = json.load(f)
        for name, augs in d.items():
            merged.setdefault(name, [])
            merged[name] += augs
    with open(output_json_path, "w") as f:
        json.dump(merged, f)
    logging.info("merged %d jsons into %s", len(list_of_jsons), output_json_path)
    logging.info("%s", get_dict_of_value_counts_image_name_to_num_aug_images(merged))
    return merged


def merge_aug_jsons_with_amount_per_json(dict_json_amount: dict, output_json_path: str, seed: int = 0) -> dict:
    output_json_path = output_json_path.replace(".json", "-merged.json")
    assert all(jp != output_json_path for jp in dict_json_amount), "output can't be an input"
    Path(output_json_path).parent.mkdir(parents=True, exist_ok=True)
    rng = pyrandom.Random(seed)
    merged: Dict[str, List[str]] = {}
    for jp, amount in dict_json_amount.items():
        with open(jp) as f:
            d = json.load(f)
        logging.info("before merge %s: %s", jp, get_dict_of_value_counts_image_name_to_num_aug_images(d))
        for name, augs in d.items():
            take = rng.sample(augs, amount) if amount < len(augs) else augs
            merged.setdefault(name, [])
            merged[name] += take
    with open(output_json_path, "w") as f:
        json.dump(merged, f)
    logging.info("merged into %s: %s", output_json_path, get_dict_of_value_counts_image_name_to_num_aug_images(merged))
    return merged


def remove_all_augs_w_sub_str_and_save(json_path: str, substr_to_remove: list, output_json_path: str) -> dict:
    with open(json_path) as f:
        d = json.load(f)
    for name, augs in d.items():
        d[name] = [p for p in augs if not any(s in p for s in substr_to_remove)]
    with open(output_json_path, "w") as f:
        json.dump(d, f)
    logging.info("removed substrings; %s", get_dict_of_value_counts_image_name_to_num_aug_images(d))
    return d
