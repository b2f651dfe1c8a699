"""Configuration of the three stages (counterpart of
saspa_tpu/utils/config.py).

`TrainConfig`, its per-dataset presets and `get_train_config` mirror the
JAX package's field for field, but for its mesh and buffer-donation
fields, which have no meaning on one card.  `GenerationConfig` mirrors the reference's module constants of
run_aug/run_aug.py:513-556, with its dataset overrides, the prompt
descriptor and the output-folder layout, field for field the JAX package's
copy, so the CLI maps onto the same configuration.  The baseline presets
(`real_guidance`, `alia`) come with the paths they run (SDEdit, ip2p, the
filter stage).
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass
from typing import Optional, Tuple

from saspa_tpu_torch.gen.tokenizer import NEGATIVE_PROMPT

DATASETS_SUPPORTED = ["planes", "cars", "dtd", "compcars-parts", "cub", "planes_biased"]

MAX_FILENAME_LENGTH = 40  # filename stem truncation shared by gen + filter (run_aug/run_aug.py:48)
MAX_PROMPT_LENGTH = 150  # prompt truncation (run_aug/run_aug.py:49)


@dataclass
class TrainConfig:
    """Training hyperparameters.  Presets mirror fgvc/configs/config_*.py."""

    dataset: str = "planes"
    seed: int = 1
    logdir: str = "logs"

    # fgvc/configs/config_planes.py:1-16
    workers: int = 4
    epochs: int = 140
    batch_size: int = 4
    learning_rate: float = 1e-3
    image_size: Tuple[int, int] = (224, 224)
    net: str = "resnet101"
    num_attentions: int = 32  # M
    beta: float = 5e-2  # feature-center EMA rate
    # the reference's per-dataset config field, which its SGD ignores (wd
    # hardcoded to 1e-5, fgvc/train.py:312); the optimizer reads
    # optimizer_weight_decay, and get_train_config warns when it is set
    weight_decay: float = 1e-4
    momentum: float = 0.9  # hardcoded in the reference (fgvc/train.py:312)
    optimizer_weight_decay: float = 1e-5  # the value SGD applies

    # lr = base * 0.9 ** ((epoch + iter/num_batches) / 2)   (fgvc/train.py:407-414)
    lr_decay_rate: float = 0.9
    lr_decay_duration: float = 2.0

    # augmentation options (fgvc/train.py:58-78)
    aug_json: Optional[str] = None
    aug_sample_ratio: Optional[float] = None
    limit_aug_per_image: Optional[int] = None
    stop_aug_after_epoch: Optional[int] = None
    special_aug: Optional[str] = "classic"
    train_sample_ratio: float = 1.0
    dont_use_wsdan: bool = False
    use_cutmix: bool = False
    use_target_soft_cross_entropy: bool = False
    few_shot: Optional[int] = None

    # checkpoint / io
    ckpt: Optional[str] = None
    model_name: str = "model.ckpt"
    save_dir: Optional[str] = None

    # eval cadence: every 10 epochs + tail (fgvc/train.py:366)
    val_every: int = 10
    early_stop_patience: int = 20  # stale validations before stop (fgvc/train.py:395-397)

    compute_dtype: str = "bfloat16"  # the reference's fp16 AMP; bf16 on the card

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


_TRAIN_PRESETS = {
    # fgvc/configs/config_planes.py (bs4, r101, wd1e-4), also planes_biased
    "planes": dict(batch_size=4, net="resnet101", weight_decay=1e-4),
    "planes_biased": dict(batch_size=4, net="resnet101", weight_decay=1e-4),
    # fgvc/configs/config_cars.py (bs8, wd1e-3)
    "cars": dict(batch_size=8, net="resnet101", weight_decay=1e-3),
    # fgvc/configs/config_cub.py / config_dtd.py (bs16, wd1e-3)
    "cub": dict(batch_size=16, net="resnet101", weight_decay=1e-3),
    "dtd": dict(batch_size=16, net="resnet101", weight_decay=1e-3),
    # fgvc/configs/config_compcars_parts.py (bs8, resnet50, wd1e-5)
    "compcars-parts": dict(batch_size=8, net="resnet50", weight_decay=1e-5),
    # fgvc/configs/config_original_cal_params.py (448^2, bs4)
    "original_cal": dict(batch_size=4, net="resnet101", weight_decay=1e-5, image_size=(448, 448)),
}


def get_train_config(dataset: str, preset: Optional[str] = None, **overrides) -> TrainConfig:
    """`preset` layers a named preset (e.g. "original_cal", the 448^2 CAL
    paper settings) over the dataset's own; None overrides are ignored."""
    if dataset not in DATASETS_SUPPORTED:
        raise ValueError(f"Unsupported dataset {dataset!r}; supported: {DATASETS_SUPPORTED}")
    base = dict(_TRAIN_PRESETS[dataset])
    if preset is not None:
        base.update(_TRAIN_PRESETS[preset])
    base.update({k: v for k, v in overrides.items() if v is not None})
    cfg = TrainConfig(dataset=dataset, **base)
    if overrides.get("weight_decay") is not None:
        logging.warning(
            "weight_decay=%s mirrors the reference's config field, which its SGD ignores (wd hardcoded 1e-5, "
            "fgvc/train.py:312); the optimizer applies optimizer_weight_decay=%s — override THAT to change decay",
            cfg.weight_decay, cfg.optimizer_weight_decay)
    if cfg.few_shot:  # few-shot forces 100 epochs (fgvc/train.py:190-197)
        cfg = cfg.replace(epochs=100)
    return cfg


@dataclass
class GenerationConfig:
    """Generation-stage parameters (module constants in run_aug/run_aug.py:513-556)."""

    dataset: str = "planes"
    version: str = "v1"
    base_model: str = "sd_v1.5"
    controlnet: Optional[str] = "canny"
    sdedit: bool = False
    sdedit_strength: float = 0.85
    num_per_image: int = 2
    seed: int = 1

    # prompts
    prompt_type: str = "gpt-meta_class"  # txt2sentence | txt2sentence-per_class | captions | gpt-meta_class | ALIA
    prompt_with_sub_class: bool = True
    use_artistic_prompts: bool = True
    artistic_prompts_prob: float = 0.5
    use_camera_variations_prompts: bool = False
    camera_variations_prob: float = 0.5
    prompts_file: Optional[str] = None
    blip_captions: Optional[str] = None

    # sampling
    resolution: int = 512
    guidance_scale: float = 7.5
    num_inference_steps: int = 30
    sampler: str = "ddim"  # ddim | unipcmultistep
    negative_prompt: Optional[str] = NEGATIVE_PROMPT

    # controlnet
    low_threshold_canny: int = 120
    high_threshold_canny: int = 200
    controlnet_conditioning_scale: float = 0.75

    # blip-diffusion
    style_img_from_diff_img: bool = True

    # execution
    batch_size: int = 8  # generation items per device batch
    mesh_shape: Optional[Tuple[int, ...]] = None
    weights_dir: Optional[str] = None  # a tree of public checkpoint files (weights/sources.py)

    debug: bool = False
    specific_file_strs: Optional[Tuple[str, ...]] = None

    def replace(self, **kw) -> "GenerationConfig":
        return dataclasses.replace(self, **kw)

    def with_dataset_overrides(self) -> "GenerationConfig":
        """Dataset-conditional overrides (run_aug/run_aug.py:560-586)."""
        cfg = self
        if "cars" in cfg.dataset.lower():
            cfg = cfg.replace(num_inference_steps=50)
        if cfg.dataset.lower() == "cub":
            cfg = cfg.replace(base_model="sd_xl-turbo")
        if cfg.base_model == "sd_xl-turbo":
            cfg = cfg.replace(guidance_scale=0.0, num_inference_steps=2, negative_prompt=None)
        if cfg.sdedit:
            assert cfg.num_inference_steps * cfg.sdedit_strength >= 1
        return cfg

    @property
    def prompt_str(self) -> str:
        """Output-folder prompt descriptor (run_aug/run_aug.py:668-676)."""
        s = self.prompt_type
        if self.prompt_with_sub_class:
            s += "_prompt_w_sub_class"
        if self.use_artistic_prompts:
            s += f"_artistic_prompts_p_{self.artistic_prompts_prob}"
        if self.use_camera_variations_prompts:
            s += f"_camera_variations_p_{self.camera_variations_prob}"
        if "blip_diffusion" in self.base_model and self.style_img_from_diff_img:
            s += "_style_img_from_diff_img"
        return s

    def output_folder(self, ds_root: str) -> str:
        """Aug-image folder layout (run_aug/run_aug.py:678-692), an artifact
        contract of the aug-JSON matcher.  The reference also computes a
        param-encoding last_folder_name (:682-687) but never appends it to
        the path (:692); this is the layout it actually uses."""
        base_model_folder = f"regular/{self.base_model}"
        if self.sdedit:
            base_model_folder += f"-SDEdit_strength_{self.sdedit_strength}"
        if self.controlnet:
            base_model_folder = base_model_folder.replace("regular/", "controlnet/")
        return (
            f"{ds_root}/aug_data/{base_model_folder}/{self.controlnet}/"
            f"{self.prompt_str}_seed_{self.seed}/images"
        )


@dataclass
class FilterConfig:
    """Filter-stage parameters (all_utils/utils.py:221-235 signature), field
    for field the JAX package's copy."""

    dataset: str = "planes"
    lpips_min: Optional[float] = None
    lpips_max: Optional[float] = None
    resize: Tuple[int, int] = (256, 256)
    clip_filtering: Optional[str] = None  # None | "per_class"
    clip_filtering_discount: float = 1.0
    semantic_filtering: bool = True
    model_confidence_based_filtering: bool = True
    conf_top_k: int = 10
    filter_confidence_higher_than: Optional[float] = None
    alia_conf_filtering: bool = False

    batch_size: int = 64  # images scored per device step (reference scores 1 at a time)

    def __post_init__(self):
        if self.clip_filtering and self.model_confidence_based_filtering:
            raise ValueError("can't use both clip_filtering and model_confidence_based_filtering")
