"""SD1.5 and SDXL(-Turbo) + canny-ControlNet generation (counterpart of
saspa_tpu/diffusion/pipelines.py).

`DiffusionPipeline(...)` owns the text towers, UNet, ControlNet and VAE
decoder; `make_fused_generate(...)` returns the whole-batch generation
function: on-device Canny, the text towers for the prompt and the negative
prompt, the CFG DDIM loop over UNet + ControlNet, VAE decode and the uint8
quantisation.  SDXL (`sd_xl`, `sd_xl-turbo`) runs two towers (ViT-L and
OpenCLIP bigG, hidden states concatenated to 2048, bigG's projected pooled
output) and the text_time added conditions (the pooled embedding and the
time ids (h, w, 0, 0, h, w)); SDXL-Turbo samples on trailing-spaced DDIM
steps, and its recipe's guidance scale 0 runs no negative tower.  With
`weights_dir` the models load from the public checkpoint files of a tree
(weights/sources.py: the family's files whole, the ControlNet's on its own);
what the tree lacks takes a seeded random init (`torch.Generator`) with a
warning, or raises under SASPA_STRICT_WEIGHTS=1.  `load_flax_params`
carries a flax param tree in through the bridge.  BLIP-Diffusion (`blip_diffusion`,
`blip_diffusion-controlnet`) is the SD1.5 pipeline plus a vision tower and a
Q-Former (`models/blip_diffusion.py`); `init_pipeline` builds any of them.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from saspa_tpu_torch import default_dtype, resolve_device
from saspa_tpu_torch.bridge import params_from_flax
from saspa_tpu_torch.diffusion.sampler import make_sample_loop
from saspa_tpu_torch.diffusion.schedulers import DDIMScheduler, SchedulerConfig
from saspa_tpu_torch.gen.tokenizer import EOT, default_tokenizer
from saspa_tpu_torch.models.controlnet import ZERO_INIT_PREFIXES, ControlNet
from saspa_tpu_torch.models.layers import init_weights, nearest_resize
from saspa_tpu_torch.models.text_encoder import SD15_TEXT, SDXL_TEXT_BIGG, SDXL_TEXT_L, CLIPTextEncoder
from saspa_tpu_torch.models.unet import UNET_CONFIGS, UNet2DCondition
from saspa_tpu_torch.models.vae import SD_VAE, SDXL_VAE, AutoencoderKL
from saspa_tpu_torch.ops.canny import canny_control_image

XL_BASE_MODELS = ("sd_xl", "sd_xl-turbo")
BASE_MODELS = ("sd_v1.5", "blip_diffusion", "blip_diffusion-controlnet") + XL_BASE_MODELS  # ported so far


@dataclass
class PipelineSpec:
    is_xl: bool
    text_cfgs: Tuple
    vae_cfg: object
    scheduler_cfg: SchedulerConfig


def _spec(base_model: str) -> PipelineSpec:
    """The JAX package's `_spec` for the ported base models: SD1.5's tower
    and VAE, or SDXL's two towers and VAE (scaling 0.13025); DDIM with
    trailing spacing for SDXL-Turbo, leading otherwise."""
    if base_model not in BASE_MODELS:
        raise ValueError(base_model)
    is_xl = base_model in XL_BASE_MODELS
    text_cfgs = (SDXL_TEXT_L, SDXL_TEXT_BIGG) if is_xl else (SD15_TEXT,)
    sched = SchedulerConfig(timestep_spacing="trailing" if base_model == "sd_xl-turbo" else "leading")
    return PipelineSpec(is_xl, text_cfgs, SDXL_VAE if is_xl else SD_VAE, sched)


def openclip_pad(ids: torch.Tensor) -> torch.Tensor:
    """EOT padding rewritten to OpenCLIP's zero padding: rows are [SOT,
    tokens..., EOT, EOT, ...]; the first EOT stays, later ones become 0
    (the OpenCLIP tokenizers pad with "!" = id 0, and padded positions feed
    cross-attention)."""
    is_eot = ids == EOT
    first = is_eot & (torch.cumsum(is_eot.int(), dim=1) == 1)
    return torch.where(is_eot & ~first, torch.zeros_like(ids), ids)


class DiffusionPipeline:
    def __init__(self, base_model: str = "sd_v1.5", controlnet: Optional[str] = "canny", sampler: str = "ddim",
                 dtype: Optional[torch.dtype] = None, device=None, weights_dir: Optional[str] = None,
                 init_seed: Optional[int] = 0, unet_cfg=None, vae_cfg=None, text_cfgs=None,
                 pallas_group_norm: bool = False, attention_megakernel: bool = False):
        """weights_dir: a tree of public checkpoint files (weights/sources.py),
        loaded strictly; `weights_loaded` says whether the base family came
        from it, `load_report` holds one report per model loaded.
        init_seed=None leaves what was not loaded at zero for a caller that
        loads weights next (load_flax_params or load_state_dict).

        The kernel configuration: by default what the JAX main path runs by
        default.  pallas_group_norm=True and attention_megakernel=True are the
        counterparts of SASPA_PALLAS_GN=1 and SASPA_ATTN_MEGAKERNEL=1 (with
        SASPA_PALLAS_LN=1, which needs no switch here: the one-pass LayerNorm
        is the default path's function): GroupNorm with the TPU kernel's
        numerics where its split plan admits the site, and the self-attention
        block kernel where `attention_block_eligible` admits it."""
        if base_model not in BASE_MODELS or sampler != "ddim" or controlnet not in (None, "canny"):
            raise NotImplementedError(f"ported so far: {'/'.join(BASE_MODELS)} + canny/None + ddim, got "
                                      f"{base_model}, {controlnet}, {sampler}")
        self.device = resolve_device(device)
        self.dtype = dtype if dtype is not None else default_dtype(self.device)
        self.base_model, self.controlnet_kind = base_model, controlnet
        self.spec = _spec(base_model)
        self.unet_cfg = unet_cfg or UNET_CONFIGS[base_model]
        self.vae_cfg = vae_cfg or self.spec.vae_cfg
        self.text_cfgs = tuple(text_cfgs or self.spec.text_cfgs)
        self.tokenizer = default_tokenizer(weights_dir)
        self.scheduler = DDIMScheduler(self.spec.scheduler_cfg, device=self.device)
        self.latent_factor = 2 ** (len(self.vae_cfg.block_out_channels) - 1)

        dev, dt = self.device, self.dtype
        gn, mk = pallas_group_norm, attention_megakernel
        self.params = {
            "text": [CLIPTextEncoder(c, dt, dev) for c in self.text_cfgs],
            "unet": UNet2DCondition(self.unet_cfg, dt, dev, pallas_group_norm=gn, attention_megakernel=mk),
            "vae": AutoencoderKL(self.vae_cfg, dt, dev, pallas_group_norm=gn),
        }
        if controlnet:
            self.params["controlnet"] = ControlNet(self.unet_cfg, dt, dev, pallas_group_norm=gn,
                                                   attention_megakernel=mk)
        self.params.update(self._extra_modules())
        for m in self._modules():
            m.eval()
        self.weights_loaded = False
        self.load_report = []
        unloaded = list(self.params)
        if weights_dir is not None:
            from saspa_tpu_torch.weights.load import load_pipeline_weights, missing_weights

            loaded, self.load_report = load_pipeline_weights(self, weights_dir)
            self.weights_loaded = "unet" in loaded
            unloaded = [k for k in self.params if k not in loaded]
            if unloaded:
                missing_weights(f"checkpoint files for {base_model}'s {', '.join(unloaded)}", weights_dir)
        if init_seed is not None and unloaded:
            self._random_init(init_seed, unloaded)

        self._sample = make_sample_loop(
            lambda p, lat, t, ctx, ac, dr, mr: p(lat, t, ctx, dr, mr, ac),
            self.scheduler,
            (lambda p, lat, t, ctx, emb, scale, ac: p(lat, t, ctx, emb, scale, ac)) if controlnet else None,
            lambda p, z: p.decode(z),
            self.vae_cfg.scaling_factor,
            controlnet_embed=(lambda p, cimg: p.embed_cond(cimg)) if controlnet else None,
        )

    def _modules(self):
        return [m for v in self.params.values() for m in (v if isinstance(v, list) else [v])]

    def _extra_modules(self) -> dict:
        """Models a subclass adds to params before they are loaded or seeded."""
        return {}

    def _random_init(self, seed: int, names=None) -> None:
        """Seeded init of params[name] for each name (default: all)."""
        names = list(self.params) if names is None else names
        logging.warning("no weights for %s's %s: seeded random init (outputs are not meaningful images)",
                        self.base_model, ", ".join(names))
        seeds = {"unet": seed, "vae": seed + 1, "controlnet": seed + 7}
        for name in names:
            if name == "text":
                for i, te in enumerate(self.params["text"]):
                    init_weights(te, seed + 2 + i)
            else:
                init_weights(self.params[name], seeds[name],
                             zero_prefixes=ZERO_INIT_PREFIXES if name == "controlnet" else ())

    def load_flax_params(self, flax_params) -> list:
        """Loads a flax param tree (numpy leaves) strictly: one subtree per
        model of the pipeline, every key.  Returns the flax paths the bridge
        skipped (the VAE encoder)."""
        sds, skipped = params_from_flax(flax_params)
        if set(sds) != set(self.params) or len(sds["text"]) != len(self.params["text"]):
            raise KeyError(f"flax subtrees {sorted(sds)} do not match the pipeline's {sorted(self.params)}")
        for k, sd in sds.items():
            for mod, msd in (zip(self.params[k], sd) if k == "text" else [(self.params[k], sd)]):
                mod.load_state_dict(msd, strict=True)
        self.weights_loaded = True
        return skipped

    def encode_ids(self, text_params, ids):
        """Every text tower on EOT-padded ids (B, 77) -> (context, pooled):
        the towers' hidden states concatenated on the last axis, and the last
        tower's projected pooled output where it has a projection (SDXL's
        bigG), else its pooled output.  The OpenCLIP (gelu) towers take
        `openclip_pad`'s ids."""
        ids = torch.as_tensor(ids, device=self.device).long()
        hiddens, pooled = [], None
        for te in text_params:
            out = te(openclip_pad(ids) if te.cfg.act == "gelu" else ids)
            hiddens.append(out["hidden"])
            pooled = out.get("proj", out["pooled"])
        return (hiddens[0] if len(hiddens) == 1 else torch.cat(hiddens, dim=-1)), pooled

    def make_time_ids(self, b: int, height: int, width: int) -> torch.Tensor:
        """SDXL's time ids, (B, 6) f32: (original h, w, crop top, left, target h, w)."""
        row = torch.tensor([[height, width, 0, 0, height, width]], dtype=torch.float32, device=self.device)
        return row.repeat(b, 1)

    def make_fused_generate(self, height: int, width: int, num_inference_steps: int, guidance_scale: float,
                            controlnet_scale: float = 0.75, canny_low: float = 120.0, canny_high: float = 200.0):
        """Returns fn(params, ids, neg_ids, src_images, latents) -> (B, H, W, 3)
        uint8 images on the pipeline's device.  ids/neg_ids: (B, 77) token ids
        (neg_ids unused without CFG, guidance_scale <= 1); src_images: (B, H,
        W, 3) uint8 (or float in [0, 255]); latents: (B, H/f, W/f, 4) f32;
        numpy arrays or tensors.  With return_images=True it also returns the
        [0, 1] f32 images before quantisation."""
        denoise = self._denoise(height, width, num_inference_steps, guidance_scale, controlnet_scale, canny_low,
                                canny_high)
        do_cfg = guidance_scale > 1.0

        @torch.no_grad()
        def fused(params, ids, neg_ids, src_images, latents, return_images: bool = False):
            ctx, pooled = self.encode_ids(params["text"], ids)
            nctx = ac = nac = None
            if do_cfg:
                nctx, npooled = self.encode_ids(params["text"], neg_ids)
            if self.spec.is_xl:
                tids = self.make_time_ids(ctx.shape[0], height, width)
                ac = {"text_embeds": pooled, "time_ids": tids}
                if do_cfg:
                    nac = {"text_embeds": npooled, "time_ids": tids}
            return denoise(params, ctx, nctx, src_images, latents, return_images, ac, nac)

        return fused

    def _denoise(self, height: int, width: int, num_inference_steps: int, guidance_scale: float,
                 controlnet_scale: float, canny_low: float, canny_high: float):
        """The fused function's part after the text towers:
        fn(params, ctx, nctx, src_images, latents, return_images, ac, nac)
        -> uint8 images (and the [0, 1] f32 images): on-device Canny, the CFG
        DDIM loop, VAE decode, quantisation.  nctx is None without CFG; ac and
        nac are SDXL's added conditions of the prompt and the negative."""
        timesteps = self.scheduler.timesteps(num_inference_steps)
        dev = self.device

        def denoise(params, ctx, nctx, src_images, latents, return_images, ac=None, nac=None):
            # uint8 sources: values 0-255 are exact in f32, so the cast is exact
            src = torch.as_tensor(src_images, device=dev).float()
            control = None
            if self.controlnet_kind == "canny":
                control = canny_control_image(src, canny_low, canny_high)
                lf = self.latent_factor
                ch, cw = (height // lf) * 8, (width // lf) * 8
                if (ch, cw) != (height, width):
                    control = nearest_resize(control, ch, cw)
            lat = torch.as_tensor(latents, device=dev).float()
            out = self._sample(params, lat, ctx, nctx, timesteps, guidance_scale=float(guidance_scale),
                               control_image=control, controlnet_scale=float(controlnet_scale), added_cond=ac,
                               uncond_added_cond=nac)
            u8 = torch.clamp(torch.round(out * 255.0), 0, 255).to(torch.uint8)
            return (u8, out) if return_images else u8

        return denoise


def init_pipeline(base_model: str, controlnet: Optional[str], SDEdit: bool = False, sampler: str = "ddim",
                  weights_dir: Optional[str] = None, dtype: Optional[torch.dtype] = None,
                  device=None) -> DiffusionPipeline:
    """Name-compatible with the reference's init_pipeline (run_aug/run_aug.py:128)
    and the JAX package's: SD1.5, SDXL, SDXL-Turbo or BLIP-Diffusion, with a
    canny ControlNet or none, DDIM, loaded from the public files under
    weights_dir; what it lacks takes the seeded random init (seed 0)."""
    blip = base_model in ("blip_diffusion", "blip_diffusion-controlnet")
    if SDEdit and blip:
        # the JAX package's refusal: the reference's blip + SDEdit call passes
        # arguments its BLIP pipelines do not declare
        raise ValueError("SDEdit is not supported with blip_diffusion; use "
                         "base_model='blip_diffusion-edit' for the inversion-edit path")
    if base_model == "sd_xl" and SDEdit and controlnet is None:
        # the JAX package maps sd_xl + SDEdit to the SDXL refiner (run_aug/run_aug.py:149-151)
        raise NotImplementedError("sd_xl + SDEdit runs the SDXL refiner, which comes with SDEdit and the VAE "
                                  "encoder (ROADMAP Queue 1 item 12)")
    if base_model not in BASE_MODELS or SDEdit or controlnet not in (None, "canny") or sampler != "ddim":
        raise NotImplementedError(
            f"ported so far: {'/'.join(BASE_MODELS)} + canny/None + ddim; {base_model}, "
            f"controlnet={controlnet}, SDEdit={SDEdit}, {sampler} come with the other generation families "
            "(ROADMAP Queue 1 item 12; blip_diffusion-edit's DDIM inversion needs the VAE encoder, which comes "
            "with SDEdit)")
    if blip:
        from saspa_tpu_torch.models.blip_diffusion import BlipDiffusionPipeline

        return BlipDiffusionPipeline(controlnet=controlnet, sampler=sampler, dtype=dtype, device=device,
                                     weights_dir=weights_dir, init_seed=0)
    return DiffusionPipeline(base_model, controlnet=controlnet, sampler=sampler, dtype=dtype, device=device,
                             weights_dir=weights_dir, init_seed=0)
