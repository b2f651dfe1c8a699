"""The best per-dataset training recipes and the sweep runner (counterpart of
saspa_tpu/gen/recipes.py).

The reference's sweep scripts (fgvc/trainings_scripts/
consecutive_runs_aug.sh:17-43, consecutive_runs_aug_few_shot.sh:15-41,
consecutive_runs_best_classic_aug.sh) as data: each dataset's special_aug
and aug_sample_ratio (planes classic/0.4, cars classic-cutmix/0.4,
compcars-parts randaug-cutmix/0.4, cub classic/0.1, dtd classic-cutmix/0.4),
limit_aug_per_image 2, seeds 1-3; few-shot K in {4, 8, 12, 16} at ratio
0.6.  `run_sweep` runs them one after the other through the port's
`fgvc/runner.py::run_training`, on `device` (None: the card).
"""

from __future__ import annotations

from argparse import Namespace
from dataclasses import dataclass
from typing import List, Optional, Sequence

BEST_RECIPES = {
    "planes": {"special_aug": "classic", "aug_sample_ratio": 0.4},
    "cars": {"special_aug": "classic-cutmix", "aug_sample_ratio": 0.4},
    "compcars-parts": {"special_aug": "randaug-cutmix", "aug_sample_ratio": 0.4},
    "cub": {"special_aug": "classic", "aug_sample_ratio": 0.1},
    "dtd": {"special_aug": "classic-cutmix", "aug_sample_ratio": 0.4},
    "planes_biased": {"special_aug": "classic", "aug_sample_ratio": 0.4},
}

FEW_SHOT_KS = (4, 8, 12, 16)
FEW_SHOT_AUG_RATIO = 0.6
LIMIT_AUG_PER_IMAGE = 2
SWEEP_SEEDS = (1, 2, 3)


@dataclass
class SweepRun:
    dataset: str
    seed: int
    special_aug: str
    aug_sample_ratio: float
    limit_aug_per_image: int = LIMIT_AUG_PER_IMAGE
    aug_json: Optional[str] = None
    few_shot: Optional[int] = None
    net: str = "resnet50"
    run_name: str = "saspa"

    @property
    def logdir(self) -> str:
        parts = [self.run_name, self.net, self.special_aug, f"ratio_{self.aug_sample_ratio}", f"seed_{self.seed}"]
        if self.few_shot:
            parts.insert(1, f"few_shot_{self.few_shot}")
        return f"logs/{self.dataset}/{'-'.join(parts)}"

    def train_args(self) -> Namespace:
        """The `cli train` flags of this run."""
        return Namespace(
            dataset=self.dataset, seed=self.seed, logdir=self.logdir,
            epochs=None, learning_rate=None, batch_size=None, weight_decay=None,
            net=self.net, aug_json=self.aug_json, aug_sample_ratio=self.aug_sample_ratio,
            limit_aug_per_image=self.limit_aug_per_image, stop_aug_after_epoch=None,
            special_aug=self.special_aug, train_sample_ratio=1.0,
            dont_use_wsdan=False, use_cutmix=False, use_target_soft_cross_entropy=False,
            few_shot=self.few_shot, ckpt=None, wandb=False,
        )


def sweep_runs(
    dataset: str,
    aug_json: Optional[str],
    net: str = "resnet50",
    seeds: Sequence[int] = SWEEP_SEEDS,
    few_shot: bool = False,
    run_name: str = "saspa",
) -> List[SweepRun]:
    recipe = BEST_RECIPES[dataset]
    shots = FEW_SHOT_KS if few_shot else (None,)
    ratio = FEW_SHOT_AUG_RATIO if few_shot else recipe["aug_sample_ratio"]
    return [SweepRun(dataset=dataset, seed=seed, special_aug=recipe["special_aug"], aug_sample_ratio=ratio,
                     aug_json=aug_json, few_shot=k, net=net, run_name=run_name)
            for k in shots for seed in seeds]


def run_sweep(dataset: str, aug_json: Optional[str], device=None, **kw):
    """The sweep's runs one after the other (the reference's consecutive
    shell loops): {logdir: run_training's result}."""
    from saspa_tpu_torch.fgvc.runner import run_training

    return {run.logdir: run_training(run.train_args(), device=device)
            for run in sweep_runs(dataset, aug_json, **kw)}
