"""Offline prompt-preparation tools, run once a dataset (counterpart of
saspa_tpu/gen/caption_tools.py):

  * write_captions_of_a_dataset_to_json -- BLIP captions (and, with
    questions, BLIP VQA answers) into the captions JSON {image_path:
    {"caption": str, <question>: answer}} that the 'captions' prompt type
    reads (prompts_engineering/blip_utils.py:28-58);
  * generate_txt2sentence_prompts -- keytotext T5 sentences with the
    keyword check and dedup (prompts_engineering/txt2sentance_prompts.py:
    9-56), written as LE_{num}_{ds}_all_classes_{b}.json;
  * extract_unique_alia_prompts -- ALIA's prompt post-processing
    (prompts_engineering/ALIA_prompts/get_unique_prompts.py).

The generators are pluggable callables.  The default factories build the
port's models (models/blip_caption.py, blip_vqa.py, t5.py) on `device`
(None: the card) from the public checkpoint files under `weights_dir`
(else $SASPA_WEIGHTS_DIR, else ./weights); without those files they raise
the JAX package's RuntimeError.  The JAX package's second choice,
transformers' torch models, is not taken: the card's machine has no
transformers.
"""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

# one of these keywords must appear in a generated sentence
# (prompts_engineering/txt2sentance_prompts.py:84-91)
DATASET_TO_LABEL_DICT = {
    "planes": ["airplane", "plane", "aircraft", "jet", "aircraft"],
    "cars": ["car", "vehicle", "automobile", "auto", "motorcar"],
    "compcars": ["car", "vehicle", "automobile", "auto", "motorcar"],
    "compcars-parts": ["car", "vehicle", "automobile", "auto", "motorcar"],
    "cub": ["bird"],
    "dtd": ["texture"],
}


def write_captions_of_a_dataset_to_json(
    dataset_name: str,
    image_paths: Sequence[str],
    output_file: str,
    questions: Sequence[str] = (),
    captioner: Optional[Callable[[str], str]] = None,
    vqa: Optional[Callable[[str, str], str]] = None,
    weights_dir: Optional[str] = None,
    device=None,
) -> Dict[str, dict]:
    """Writes the captions JSON the 'captions' prompt type reads."""
    if captioner is None:
        captioner = _default_captioner(weights_dir, device)
    if questions and vqa is None:
        vqa = _default_vqa(weights_dir, device)
    Path(output_file).parent.mkdir(parents=True, exist_ok=True)
    out: Dict[str, dict] = {}
    for p in image_paths:
        entry = {"caption": captioner(p)}
        if questions:
            if hasattr(vqa, "answer_questions"):
                # one vision pass an image, every question in one decode;
                # a plain (path, q) callable answers pair by pair
                entry.update(zip(questions, vqa.answer_questions(p, questions)))
            else:
                for q in questions:
                    entry[q] = vqa(p, q)
        out[p] = entry
    with open(output_file, "w") as f:
        json.dump(out, f)
    logging.info("wrote %d captions to %s", len(out), output_file)
    return out


def _weights_dir(weights_dir: Optional[str]) -> str:
    return weights_dir or os.environ.get("SASPA_WEIGHTS_DIR", "weights")


def _require_file(weights_dir: str, part: str, no_model: str, instead: str) -> None:
    """The public file of `part` must lie under weights_dir; the JAX
    package's converted directory of the same name is refused."""
    from saspa_tpu_torch.weights.load import refuse_orbax
    from saspa_tpu_torch.weights.sources import PARTS, find_source

    if find_source(weights_dir, part) is None:
        if (Path(weights_dir) / part).is_dir():
            refuse_orbax(Path(weights_dir) / part)
        raise RuntimeError(f"No {no_model} available: no public checkpoint under {weights_dir} "
                           f"({' or '.join(PARTS[part].srcs)}). {instead}")


def _default_captioner(weights_dir: Optional[str] = None, device=None):
    """The port's BLIP captioner on LAVIS's caption checkpoint under weights_dir."""
    weights_dir = _weights_dir(weights_dir)
    _require_file(weights_dir, "blip_caption", "BLIP captioner", "Pass captioner= explicitly, or use the shipped "
                  "captions assets in prompts_engineering/captions.")
    from saspa_tpu_torch.models.blip_caption import TorchBlipCaptioner

    return TorchBlipCaptioner(weights_dir=weights_dir, device=device)


def _default_vqa(weights_dir: Optional[str] = None, device=None):
    """The port's BLIP VQA on LAVIS's vqav2 checkpoint under weights_dir (the
    reference loads blip_vqa beside the captioner, blip_utils.py:35)."""
    weights_dir = _weights_dir(weights_dir)
    _require_file(weights_dir, "blip_vqa", "BLIP VQA", "Pass vqa= explicitly, or drop --questions (captions "
                  "alone cover the published recipes).")
    from saspa_tpu_torch.models.blip_vqa import TorchBlipVQA

    return TorchBlipVQA(weights_dir=weights_dir, device=device)


def generate_txt2sentence_prompts(
    dataset: str,
    num: int,
    output_path: str,
    all_classes: bool = False,
    sentence_generator: Optional[Callable[[str], str]] = None,
    classnames: Optional[List[str]] = None,
    weights_dir: Optional[str] = None,
    device=None,
) -> str:
    """Keyword -> sentence prompt pool with the membership check and dedup;
    writes LE_{num}_{dataset}_all_classes_{all_classes}.json in the
    {class: [sentences]} schema read_prompts_from_json reads."""
    assert dataset in DATASET_TO_LABEL_DICT
    if sentence_generator is None:
        sentence_generator = _default_sentence_generator(weights_dir, device)
    must_keywords = DATASET_TO_LABEL_DICT[dataset]

    if classnames is None:
        if all_classes:
            from saspa_tpu_torch.data.registry import DS_UTILS_DICT

            classnames = DS_UTILS_DICT[dataset]().get_classes()
        elif dataset == "compcars-parts":
            from saspa_tpu_torch.data.registry import CompCarsPartsUtils

            utils_to_use = CompCarsPartsUtils()
            classnames = [utils_to_use.get_basic_prompt(str(p)) for p in range(1, 5)]
        else:
            classnames = list(must_keywords)

    skipped = 0
    result: Dict[str, List[str]] = {}
    for cls in classnames:
        sentences = []
        for _ in range(num):
            inp = f"{must_keywords[0]}, of type {cls}" if all_classes else (
                cls if dataset == "compcars-parts" else must_keywords[0]
            )
            s = sentence_generator(inp)
            if any(kw in s.lower() for kw in must_keywords):
                sentences.append(s)
            else:
                skipped += 1
        result[cls] = sorted(set(sentences))
    logging.info("skipped %d sentences without keywords", skipped)

    Path(output_path).mkdir(parents=True, exist_ok=True)
    save_path = Path(output_path) / f"LE_{num}_{dataset}_all_classes_{all_classes}.json"
    with open(save_path, "w") as f:
        json.dump(result, f)
    return str(save_path)


def _default_sentence_generator(weights_dir: Optional[str] = None, device=None):
    """The port's keytotext T5 on mrm8488/t5-base-finetuned-common_gen's HF
    files under weights_dir (tokenizer/spiece.model beside them)."""
    weights_dir = _weights_dir(weights_dir)
    _require_file(weights_dir, "t5_keytotext", "keytotext T5", "Pass sentence_generator= explicitly, or use the "
                  "shipped assets.")
    from saspa_tpu_torch.models.t5 import TorchKeytotextT5

    return TorchKeytotextT5(weights_dir=weights_dir, device=device)


def extract_unique_alia_prompts(captions: Sequence[str], max_prompts: int = 30) -> List[str]:
    """Deduplicate / normalise GPT-summarised ALIA prompts: strip numbering
    and quotes, drop duplicates case-insensitively."""
    seen = set()
    out: List[str] = []
    for line in captions:
        s = line.strip()
        # drop leading "12." / "3)" style numbering, then surrounding quotes
        while s and (s[0].isdigit() or s[0] in ".)-"):
            s = s[1:].lstrip()
        s = s.strip('"').strip()
        key = s.lower()
        if s and key not in seen:
            seen.add(key)
            out.append(s)
        if len(out) >= max_prompts:
            break
    return out
