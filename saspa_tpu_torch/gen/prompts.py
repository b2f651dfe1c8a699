"""Prompt assembly for the generation stage (counterpart of saspa_tpu/gen/prompts.py).

The reference's prompt pipeline (run_aug/run_aug.py): the five prompt
sources (gpt-meta_class and ALIA txt files, txt2sentence JSONs per pool or
per class, BLIP captions), per-dataset file resolution (:591-666), and the
per-item assembly (:380-427): a pool pick, no trailing '.', the
compcars-parts part prefix, the artistic suffix (every second prompt at
p=0.5), the camera-variation suffix and the sub-class substitution, with the
MAX_PROMPT_LENGTH cut at pool-load time (:49,308).  Every choice keys off
(seed, image_index, prompt_index) through utils.rng, so a worklist can be
sharded and resumed in any order.  The pools are the repo's
prompts_engineering/ files.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict, List, Optional

from saspa_tpu_torch.utils import rng as rngs
from saspa_tpu_torch.utils.config import MAX_PROMPT_LENGTH, GenerationConfig

# static suffix pools (prompts_engineering/__init__.py:1-35)
ARTISTIC_PROMPTS = [
    "a painting of van gogh",
    "a painting of monet",
    "a painting of picasso",
    "a painting of da vinci",
    "a painting of michelangelo",
    "a painting of rembrandt",
    "a painting of raphael",
    "a painting of vermeer",
    "a painting of degas",
    "a painting of klimt",
]

IMAGE_VARIATIONS_PROMPTS = [
    "High-Speed",
    "Lens Flare",
    "HDR (High Dynamic Range)",
    "Fish-Eye Lens",
    "Black and White",
    "Long Exposure",
    "Macro",
    "Panoramic",
    "Tilt-Shift",
    "Infrared",
    "Bokeh",
    "Time-Lapse",
    "Underwater",
    "Double Exposure",
    "Sepia Tone",
    "Vintage Look",
    "Solarized",
    "Low Light",
    "Motion Blur",
    "Cross Processed",
]

ASSETS_DIR = Path(__file__).resolve().parent.parent.parent / "prompts_engineering"

PROMPT_TYPES = ["txt2sentence", "txt2sentence-per_class", "captions", "gpt-meta_class", "ALIA"]


def read_prompts_from_json(json_file: str, per_class: bool = False):
    """{class: [prompt, ...]} JSON -> flat list or the per-class dict
    (prompts_engineering/blip_utils.py:14-25)."""
    with open(json_file) as f:
        data = json.load(f)
    if per_class:
        return data
    prompts: List[str] = []
    for v in data.values():
        prompts += v
    return prompts


def read_captions_from_json(json_file: str) -> Dict[str, dict]:
    with open(json_file) as f:
        return json.load(f)


def resolve_prompt_files(cfg: GenerationConfig) -> GenerationConfig:
    """Per-dataset prompts_file/blip_captions resolution (run_aug/run_aug.py:591-666)."""
    ds, pt = cfg.dataset, cfg.prompt_type
    base = ASSETS_DIR
    prompts_file, blip_captions = cfg.prompts_file, cfg.blip_captions

    if ds == "dtd" and pt != "captions":
        logging.warning("DTD only supports caption prompts (paper appendix D.1); switching.")
        cfg = cfg.replace(prompt_type="captions")
        pt = "captions"

    captions_name = {
        "planes": "planes_captions.json",
        "cars": "cars_captions.json",
        "dtd": "dtd_captions.json",
        "compcars-parts": "compcars-parts_captions.json",
    }.get(ds)
    if blip_captions is None and captions_name:
        blip_captions = str(base / "captions" / captions_name)

    if prompts_file is None:
        if pt == "gpt-meta_class":
            name = {"compcars-parts": "cars", "planes_biased": "planes"}.get(ds, ds)
            prompts_file = str(base / "gpt_prompts" / f"{name}-100-gpt_v1.txt")
        elif pt == "txt2sentence":
            name = {"compcars-parts": "cars", "planes_biased": "planes"}.get(ds, ds)
            prompts_file = str(base / "txt2sentences_prompts" / f"LE_200_{name}_all_classes_False.json")
        elif pt == "txt2sentence-per_class":
            name = {"planes_biased": "planes"}.get(ds, ds)
            prompts_file = str(base / "txt2sentences_prompts" / f"LE_30_{name}_all_classes_True.json")
        elif pt == "ALIA":
            prompts_file = str(base / "ALIA_prompts" / "gpt_output" / f"{ds}_prompts.txt")

    return cfg.replace(prompts_file=prompts_file, blip_captions=blip_captions)


class PromptEngine:
    """Owns the prompt pool(s); builds the final prompt for a work item."""

    def __init__(self, cfg: GenerationConfig, ds_utils, image_classes_dict: Dict[str, str]):
        self.cfg = resolve_prompt_files(cfg)
        self.ds_utils = ds_utils
        self.image_classes_dict = image_classes_dict
        self.prompts: Optional[List[str]] = None
        self.class_to_prompts: Optional[Dict[str, List[str]]] = None
        self.captions: Optional[Dict[str, dict]] = None

        pt = self.cfg.prompt_type
        if pt in ("gpt-meta_class", "ALIA"):
            with open(self.cfg.prompts_file) as f:
                self.prompts = [p.strip()[:MAX_PROMPT_LENGTH] for p in f if p.strip()]
            logging.info("Read %d prompts from %s", len(self.prompts), self.cfg.prompts_file)
        elif pt == "txt2sentence":
            self.prompts = [p[:MAX_PROMPT_LENGTH] for p in read_prompts_from_json(self.cfg.prompts_file)]
        elif pt == "txt2sentence-per_class":
            self.class_to_prompts = {
                k: [p[:MAX_PROMPT_LENGTH] for p in v]
                for k, v in read_prompts_from_json(self.cfg.prompts_file, per_class=True).items()
            }
        elif pt == "captions":
            if not self.cfg.blip_captions:
                raise ValueError(
                    f"prompt_type='captions' needs a captions JSON for dataset "
                    f"{self.cfg.dataset!r} (none shipped — generate one with "
                    "`saspa-tpu prep-captions` or set cfg.blip_captions)"
                )
            self.captions = read_captions_from_json(self.cfg.blip_captions)
        else:
            raise ValueError(pt)

    # ------------------------------------------------------------------
    def _pool_for_image(self, image_path: str) -> List[str]:
        pt = self.cfg.prompt_type
        if pt in ("gpt-meta_class", "ALIA", "txt2sentence"):
            return self.prompts
        if pt == "captions":
            cap = self.captions[image_path]["caption"][:MAX_PROMPT_LENGTH]
            return [cap]
        if pt == "txt2sentence-per_class":
            ds = self.cfg.dataset
            key = Path(image_path).stem if ds in ("planes", "cars", "planes_biased") else image_path
            return self.class_to_prompts[self.image_classes_dict[key]]
        raise ValueError(pt)

    def build(self, image_path: str, image_index: int, prompt_index: int) -> str:
        """The final prompt for augmentation #prompt_index of image #image_index.

        No truncation happens HERE, matching the reference exactly: the
        150-char MAX_PROMPT_LENGTH cut applies at pool-load time only
        (run_aug/run_aug.py:308,333,339,345); suffixes and sub-class
        substitution are appended afterwards untruncated (:385-427) — the
        tokenizer's 77-token cap is the only final bound in both."""
        cfg = self.cfg
        ds = cfg.dataset
        pool = self._pool_for_image(image_path)
        prompt = pool[rngs.host_choice(len(pool), cfg.seed, "prompt_choice", image_index, prompt_index)]
        if prompt.endswith("."):
            prompt = prompt[:-1]

        if ds == "compcars-parts":
            part = image_path.split("/")[-2]
            prompt = f"{self.ds_utils.get_basic_prompt(part=part)} {prompt}"

        # artistic suffix: with p=0.5 exactly every 2nd prompt (run_aug:391-394)
        if cfg.use_artistic_prompts and (
            (prompt_index % 2 == 0 and cfg.artistic_prompts_prob == 0.5)
            or (
                cfg.artistic_prompts_prob != 0.5
                and rngs.host_uniform(cfg.seed, "artistic", image_index, prompt_index) < cfg.artistic_prompts_prob
            )
        ):
            pick = rngs.host_choice(len(ARTISTIC_PROMPTS), cfg.seed, "artistic", image_index, prompt_index, 1)
            prompt = f"{prompt}, {ARTISTIC_PROMPTS[pick]}"
        elif cfg.use_camera_variations_prompts and (
            rngs.host_uniform(cfg.seed, "artistic", image_index, prompt_index, 2) < cfg.camera_variations_prob
        ):
            pick = rngs.host_choice(len(IMAGE_VARIATIONS_PROMPTS), cfg.seed, "artistic", image_index, prompt_index, 3)
            prompt = f"{prompt}, {IMAGE_VARIATIONS_PROMPTS[pick]} photo"

        if cfg.prompt_with_sub_class:
            stem = Path(image_path).stem
            if ds in ("planes", "planes_biased"):
                prompt = prompt.replace("airplane", f"{self.image_classes_dict[stem]} airplane")
            elif ds == "cars":
                prompt = prompt.replace("car", f"{self.image_classes_dict[stem]} car")
            elif ds == "dtd":
                prompt = f"{prompt} with a {self.image_classes_dict[image_path]} texture"
            elif ds in ("compcars", "compcars-parts"):
                prompt = prompt.replace("car", f"{self.image_classes_dict[image_path]} car")
            elif ds == "cub":
                prompt = prompt.replace("bird", f"{self.image_classes_dict[image_path]} bird")
            else:
                raise NotImplementedError(ds)

        return prompt
