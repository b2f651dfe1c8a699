"""DDIM and UniPC schedulers (counterpart of saspa_tpu/diffusion/schedulers.py).

SD1.5 defaults: scaled-linear betas 0.00085 -> 0.012 over 1000 train steps,
epsilon prediction, steps_offset 1, leading spacing; deterministic DDIM
(eta = 0).  UniPC (`--sampler unipcmultistep`) is the JAX package's
data-prediction bh2 solver of order <= 2 on the multistep grid.  Both take
JAX's shape: `init_state(n, shape)`, then `state, lat = step(state, eps,
t, prev_t, lat)` once a timestep; DDIM's state is empty.  `add_noise` and
`sdedit_start_step` are SDEdit's forward noising and strength-truncated
schedule.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

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


def make_timesteps(cfg: SchedulerConfig, num_inference_steps: int, multistep: bool = False) -> np.ndarray:
    """Descending inference timesteps (int32).  multistep=True is UniPC's
    grid (diffusers' UniPCMultistepScheduler.set_timesteps): with leading
    spacing n + 1 points spaced T // (n + 1), the final 0 dropped."""
    T = cfg.num_train_timesteps
    if cfg.timestep_spacing == "leading":
        n = num_inference_steps + 1 if multistep else num_inference_steps
        step_ratio = T // n
        ts = (np.arange(n) * step_ratio).round().astype(np.int64)[::-1]
        ts = (ts[:-1] if multistep else ts) + cfg.steps_offset
    elif cfg.timestep_spacing == "trailing":
        step_ratio = T / num_inference_steps
        ts = np.round(np.arange(T, 0, -step_ratio)).astype(np.int64) - 1
    else:
        raise ValueError(cfg.timestep_spacing)
    return ts.astype(np.int32)


def _pred_x0_eps(prediction_type: str, sample, model_output, sqrt_a, sqrt_1ma):
    """(x0, eps) of a model output under the prediction type; sqrt_a and
    sqrt_1ma are sqrt(a_t) and sqrt(1 - a_t)."""
    if prediction_type == "epsilon":
        return (sample - sqrt_1ma * model_output) / sqrt_a, model_output
    if prediction_type == "v_prediction":
        return sqrt_a * sample - sqrt_1ma * model_output, sqrt_a * model_output + sqrt_1ma * sample
    raise ValueError(prediction_type)


class _Scheduler:
    """What DDIM and UniPC share: the f32 alphas_cumprod on the device, the
    forward noising, the identity model-input scaling."""

    multistep = False

    def __init__(self, cfg: SchedulerConfig = SchedulerConfig(), device="cpu"):
        self.cfg = cfg
        self.alphas_cumprod = torch.as_tensor(_alphas_cumprod(cfg), dtype=torch.float32, device=device)

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        return make_timesteps(self.cfg, num_inference_steps, self.multistep)

    def init_state(self, num_inference_steps: int, sample_shape) -> tuple:
        return ()

    def add_noise(self, original, noise, t: int):
        """sqrt(a_t) * original + sqrt(1 - a_t) * noise, a_t read from the f32
        alphas_cumprod (as the JAX package reads it); f32 whatever the
        inputs' dtype, as JAX promotes a bf16 latent against the f32 a_t."""
        a = self.alphas_cumprod[int(t)]
        return torch.sqrt(a) * original.float() + torch.sqrt(1.0 - a) * noise.float()


class DDIMScheduler(_Scheduler):
    """Deterministic DDIM (eta = 0) on f32 tensors; memoryless."""

    def __init__(self, cfg: SchedulerConfig = SchedulerConfig(), device="cpu"):
        super().__init__(cfg, device)
        self.final_alpha_cumprod = (
            torch.ones((), dtype=torch.float32, device=device) if cfg.set_alpha_to_one else self.alphas_cumprod[0]
        )

    def step(self, state, model_output, t: int, prev_t: int, sample):
        """One reverse step t -> prev_t; prev_t < 0 means the final step.
        Returns (state, prev_sample)."""
        a_t = self.alphas_cumprod[t]
        a_prev = self.alphas_cumprod[prev_t] if prev_t >= 0 else self.final_alpha_cumprod
        x0, eps = _pred_x0_eps(self.cfg.prediction_type, sample, model_output, torch.sqrt(a_t),
                               torch.sqrt(1.0 - a_t))
        return state, torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps


class UniPCScheduler(_Scheduler):
    """UniPC multistep (the JAX package's UniPCScheduler, diffusers'
    UniPCMultistepScheduler defaults): data prediction, the bh2 solver,
    order <= 2 with one order less on the first step and on the last
    (lower_order_final), predict-then-correct: each step first corrects the
    previous predictor's output with the current model output (uni_c), then
    predicts toward prev_t (uni_p).  The state carries the last two x0
    predictions and their timesteps, the last corrected sample and the step
    counter.

    The per-step coefficients are scalars of timesteps the host knows, so
    they are computed on the host from `_ac`, the f32 alphas_cumprod as JAX
    computes them, and the branches JAX takes with `jnp.where` are Python
    branches; the tensors only meet those scalars in the combinations JAX
    forms."""

    multistep = True
    solver_order = 2

    def __init__(self, cfg: SchedulerConfig = SchedulerConfig(), device="cpu"):
        super().__init__(cfg, device)
        self._ac = torch.as_tensor(_alphas_cumprod(cfg), dtype=torch.float32)  # host copy for the coefficients

    def init_state(self, num_inference_steps: int, sample_shape) -> dict:
        return {"m_prev": None, "t_prev": -1, "m_prev2": None, "t_prev2": -1, "last_sample": None,
                "step": 0, "n_steps": int(num_inference_steps)}

    def _abl(self, t: int):
        """(alpha, sigma, lambda) at train timestep t (t < 0 reads 0), host scalars."""
        a = self._ac[max(int(t), 0)]
        alpha, sigma = torch.sqrt(a), torch.sqrt(1 - a)
        return alpha, sigma, torch.log(alpha) - torch.log(sigma)

    def _order_at(self, i: int, n: int) -> int:
        return min(self.solver_order, n - i, min(i, self.solver_order) + 1)

    def step(self, state: dict, model_output, t: int, prev_t: int, sample):
        """uni_c (the sample at t corrected with the current model output),
        then uni_p toward prev_t; prev_t < 0 means the final step.  Returns
        (state, prev_sample)."""
        f = float  # host scalars enter the tensor arithmetic as Python floats (exact)
        i, n = state["step"], state["n_steps"]
        alpha_c, sigma_c, lam_c = self._abl(t)
        # x0 of the UNCORRECTED sample enters the history (diffusers' order)
        a_t = self._ac[int(t)]
        x0_t, _ = _pred_x0_eps(self.cfg.prediction_type, sample, model_output, f(torch.sqrt(a_t)),
                               f(torch.sqrt(1.0 - a_t)))
        _, sigma_p, lam_p = self._abl(state["t_prev"])
        m0 = state["m_prev"]

        sample_c = sample
        if i > 0:  # uni_c, at the order of the previous step's predictor
            hc = lam_c - lam_p
            hhc = -hc
            phi1_c = torch.expm1(hhc)
            bh_c = phi1_c  # bh2: B(h) = expm1(hh)
            d1t = x0_t - m0
            base = f(sigma_c / sigma_p) * state["last_sample"] - f(alpha_c * phi1_c) * m0
            if self._order_at(max(i - 1, 0), n) >= 2:
                _, _, lam_p2 = self._abl(state["t_prev2"])
                r0c = (lam_p2 - lam_p) / hc
                d10c = (state["m_prev2"] - m0) / f(r0c if r0c != 0 else 1.0)
                b1c = (phi1_c / hhc - 1.0) / bh_c
                b2c = ((phi1_c / hhc - 1.0) / hhc - 0.5) * 2.0 / bh_c
                rho0 = (b1c - b2c) / (1.0 - r0c if r0c != 1.0 else 1.0)
                rho1 = b1c - rho0
                sample_c = base - f(alpha_c * bh_c) * (f(rho0) * d10c + f(rho1) * d1t)
            else:  # order-1 corrector: rhos_c = [0.5]
                sample_c = base - f(alpha_c * bh_c * 0.5) * d1t

        if prev_t < 0:  # final step: alpha 1, sigma 0, lambda -> +inf (20)
            alpha_n, sigma_n, lam_n = (torch.tensor(v, dtype=self._ac.dtype) for v in (1.0, 0.0, 20.0))
        else:
            alpha_n, sigma_n, lam_n = self._abl(prev_t)
        h = lam_n - lam_c
        phi1 = torch.expm1(-h)
        bh = phi1  # bh2
        prev_sample = f(sigma_n / sigma_c) * sample_c - f(alpha_n * phi1) * x0_t
        if self._order_at(i, n) >= 2 and prev_t >= 0:  # order-2 predictor: rhos_p = [0.5]
            r0 = (lam_p - lam_c) / h
            d10 = (m0 - x0_t) / f(r0 if r0 != 0 else 1.0)
            prev_sample = prev_sample - f(alpha_n * bh * 0.5) * d10
        new_state = {"m_prev": x0_t, "t_prev": int(t), "m_prev2": m0, "t_prev2": state["t_prev"],
                     "last_sample": sample_c, "step": i + 1, "n_steps": n}
        return new_state, prev_sample


SCHEDULERS = {"ddim": DDIMScheduler, "unipcmultistep": UniPCScheduler}


def get_scheduler(name: str, cfg: Optional[SchedulerConfig] = None, device="cpu"):
    """The `--sampler` of that name: "ddim" or "unipcmultistep"."""
    return SCHEDULERS[name](cfg or SchedulerConfig(), device=device)


def sdedit_start_step(num_inference_steps: int, strength: float) -> int:
    """img2img: the index of the first timestep that runs, skipping the first
    (1 - strength) of the schedule; int() truncates the float product, so
    50 steps at strength 0.15 run 7 (diffusers' get_timesteps)."""
    init_timestep = min(int(num_inference_steps * strength), num_inference_steps)
    return max(num_inference_steps - init_timestep, 0)
