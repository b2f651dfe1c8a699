"""DDIM scheduler (counterpart of saspa_tpu/diffusion/schedulers.py, DDIM part).

SD1.5 defaults: scaled-linear betas 0.00085 -> 0.012 over 1000 train steps,
epsilon prediction, steps_offset 1, leading spacing; deterministic DDIM
(eta = 0).  `add_noise` and `sdedit_start_step` are SDEdit's forward
noising and strength-truncated schedule.  UniPC is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class SchedulerConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"  # or "linear"
    prediction_type: str = "epsilon"  # or "v_prediction"
    steps_offset: int = 1
    timestep_spacing: str = "leading"  # or "trailing"
    set_alpha_to_one: bool = False


def _alphas_cumprod(cfg: SchedulerConfig) -> np.ndarray:
    if cfg.beta_schedule == "scaled_linear":
        betas = np.linspace(cfg.beta_start**0.5, cfg.beta_end**0.5, cfg.num_train_timesteps) ** 2
    elif cfg.beta_schedule == "linear":
        betas = np.linspace(cfg.beta_start, cfg.beta_end, cfg.num_train_timesteps)
    else:
        raise ValueError(cfg.beta_schedule)
    return np.cumprod(1.0 - betas)


def make_timesteps(cfg: SchedulerConfig, num_inference_steps: int) -> np.ndarray:
    """Descending DDIM inference timesteps (int32)."""
    T = cfg.num_train_timesteps
    if cfg.timestep_spacing == "leading":
        step_ratio = T // num_inference_steps
        ts = (np.arange(num_inference_steps) * step_ratio).round().astype(np.int64)
        ts = ts[::-1] + cfg.steps_offset
    elif cfg.timestep_spacing == "trailing":
        step_ratio = T / num_inference_steps
        ts = np.round(np.arange(T, 0, -step_ratio)).astype(np.int64) - 1
    else:
        raise ValueError(cfg.timestep_spacing)
    return ts.astype(np.int32)


class DDIMScheduler:
    """Deterministic DDIM (eta = 0) on f32 tensors."""

    def __init__(self, cfg: SchedulerConfig = SchedulerConfig(), device="cpu"):
        self.cfg = cfg
        self.alphas_cumprod = torch.as_tensor(_alphas_cumprod(cfg), dtype=torch.float32, device=device)
        self.final_alpha_cumprod = (
            torch.ones((), dtype=torch.float32, device=device) if cfg.set_alpha_to_one else self.alphas_cumprod[0]
        )

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        return make_timesteps(self.cfg, num_inference_steps)

    def step(self, model_output, t: int, prev_t: int, sample):
        """One reverse step t -> prev_t; prev_t < 0 means the final step."""
        a_t = self.alphas_cumprod[t]
        a_prev = self.alphas_cumprod[prev_t] if prev_t >= 0 else self.final_alpha_cumprod
        sqrt_a, sqrt_1ma = torch.sqrt(a_t), torch.sqrt(1.0 - a_t)
        if self.cfg.prediction_type == "epsilon":
            eps = model_output
            x0 = (sample - sqrt_1ma * eps) / sqrt_a
        elif self.cfg.prediction_type == "v_prediction":
            x0 = sqrt_a * sample - sqrt_1ma * model_output
            eps = sqrt_a * model_output + sqrt_1ma * sample
        else:
            raise ValueError(self.cfg.prediction_type)
        return torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps

    def add_noise(self, original, noise, t: int):
        """sqrt(a_t) * original + sqrt(1 - a_t) * noise, a_t read from the f32
        alphas_cumprod (as the JAX package reads it); f32 whatever the
        inputs' dtype, as JAX promotes a bf16 latent against the f32 a_t."""
        a = self.alphas_cumprod[int(t)]
        return torch.sqrt(a) * original.float() + torch.sqrt(1.0 - a) * noise.float()


def sdedit_start_step(num_inference_steps: int, strength: float) -> int:
    """img2img: the index of the first timestep that runs, skipping the first
    (1 - strength) of the schedule; int() truncates the float product, so
    50 steps at strength 0.15 run 7 (diffusers' get_timesteps)."""
    init_timestep = min(int(num_inference_steps * strength), num_inference_steps)
    return max(num_inference_steps - init_timestep, 0)
