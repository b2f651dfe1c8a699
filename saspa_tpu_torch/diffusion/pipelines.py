"""SD1.5, SD2.1 and SDXL(-Turbo) generation, with a canny or HED ControlNet
or none, text to image or SDEdit (counterpart of
saspa_tpu/diffusion/pipelines.py).

`DiffusionPipeline(...)` owns the text towers, UNet, ControlNet and VAE;
`make_fused_generate(...)` returns the whole-batch text(+control) function:
the control image on the device (Canny, or the HED network of
`models/hed.py`, which the pipeline holds as params["hed"] beside a HED
ControlNet), the text towers for the prompt and the negative prompt, the
CFG DDIM (or UniPC) loop over UNet + ControlNet, VAE decode and the uint8
quantisation.  `generate(...)` is the JAX package's unfused entry point:
the same loop from prompts, and given an `init_image` SDEdit (img2img): the
source's posterior mean through the VAE encoder, scaled, noised to the
first timestep kept by the strength, then the truncated schedule.  SD2.1
(`sd_v2.1`) is SD1.5's pipeline with OpenCLIP-H's 23-layer tower (padded
as OpenCLIP pads, `openclip_pad`) and a UNet of d-64 heads, epsilon
prediction and leading spacing, as the JAX package's `_spec` leaves them.
SDXL (`sd_xl`, `sd_xl-turbo`) runs two towers (ViT-L and OpenCLIP bigG,
hidden states concatenated to 2048, bigG's projected pooled output) and
the text_time added conditions (the pooled embedding and the time ids (h,
w, 0, 0, h, w)); SDXL-Turbo samples on trailing-spaced DDIM steps, and its
recipe's guidance scale 0 runs no negative tower.  With
SASPA_XL_VAE_FP32=1 at construction (the reference's upcast_vae, the JAX
package's switch of the same name) the XL families' VAE, encoder and
decoder, runs in f32 while the towers, UNet and ControlNet keep the
pipeline's dtype; the latents reach it in f32.  With `weights_dir` the
models load from the public checkpoint files of a tree
(weights/sources.py: the family's files whole, the ControlNet's and HED's
on their own); what the tree lacks takes a seeded random init
(`torch.Generator`) with a warning, or raises under SASPA_STRICT_WEIGHTS=1.
`load_flax_params` carries a flax param tree in through the bridge.
BLIP-Diffusion (`blip_diffusion`, `blip_diffusion-controlnet`, and the
inversion edit `blip_diffusion-edit`) is the SD1.5 pipeline plus a vision
tower and a Q-Former (`models/blip_diffusion.py`).  InstructPix2Pix (`ip2p`,
ALIA's editor for planes_biased) is SD1.5 with an 8-channel UNet input: its
`generate` takes the image to edit and runs 3-way guidance (the sampler's
`image_latents`).  `init_pipeline` builds any of them.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from saspa_tpu_torch import default_dtype, resolve_device
from saspa_tpu_torch.bridge import params_from_flax
from saspa_tpu_torch.diffusion.sampler import make_sample_loop
from saspa_tpu_torch.diffusion.schedulers import SchedulerConfig, get_scheduler, sdedit_start_step
from saspa_tpu_torch.gen.tokenizer import EOT, NEGATIVE_PROMPT, default_tokenizer
from saspa_tpu_torch.models.controlnet import ZERO_INIT_PREFIXES, ControlNet
from saspa_tpu_torch.models.hed import HED, hed_control_image
from saspa_tpu_torch.models.layers import init_weights, nearest_resize
from saspa_tpu_torch.models.text_encoder import SD15_TEXT, SD21_TEXT, SDXL_TEXT_BIGG, SDXL_TEXT_L, CLIPTextEncoder
from saspa_tpu_torch.models.unet import UNET_CONFIGS, UNet2DCondition
from saspa_tpu_torch.models.vae import SD_VAE, SDXL_VAE, AutoencoderKL
from saspa_tpu_torch.ops.canny import canny_control_image

XL_BASE_MODELS = ("sd_xl", "sd_xl-turbo", "sd_xl-refiner")
BASE_MODELS = ("sd_v1.5", "sd_v2.1", "ip2p", "blip_diffusion", "blip_diffusion-controlnet") + XL_BASE_MODELS
BLIP_BASE_MODELS = ("blip_diffusion", "blip_diffusion-controlnet", "blip_diffusion-edit")
CONTROLNET_KINDS = (None, "canny", "hed")


def quantize(images: torch.Tensor) -> torch.Tensor:
    """[0, 1] images -> uint8, on their device."""
    return torch.clamp(torch.round(images * 255.0), 0, 255).to(torch.uint8)


@dataclass
class PipelineSpec:
    is_xl: bool
    text_cfgs: Tuple
    vae_cfg: object
    scheduler_cfg: SchedulerConfig


def _spec(base_model: str) -> PipelineSpec:
    """The JAX package's `_spec`: SD1.5's tower and VAE (also
    InstructPix2Pix's), SD2.1's OpenCLIP-H tower with the SD VAE, SDXL's two
    towers and VAE (scaling 0.13025), or the refiner's bigG tower alone with
    SDXL's VAE; trailing spacing for SDXL-Turbo, leading otherwise; the
    scheduler's default prediction type (epsilon) throughout."""
    if base_model not in BASE_MODELS:
        raise ValueError(base_model)
    is_xl = base_model in XL_BASE_MODELS
    if base_model == "sd_xl-refiner":
        text_cfgs = (SDXL_TEXT_BIGG,)
    elif base_model == "sd_v2.1":
        text_cfgs = (SD21_TEXT,)
    else:
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
        block kernel where `attention_block_eligible` admits it.

        controlnet="hed" also builds the HED network (params["hed"]) that
        makes its conditioning image.  The XL families' VAE takes f32 where
        dtype is f32 or SASPA_XL_VAE_FP32=1 (`vae_dtype`)."""
        if base_model == "ip2p" and controlnet is not None:
            raise ValueError("ip2p does not support a ControlNet")
        if base_model not in BASE_MODELS or controlnet not in CONTROLNET_KINDS:
            raise ValueError(f"no pipeline {base_model} with controlnet={controlnet}")
        self.device = resolve_device(device)
        self.dtype = dtype if dtype is not None else default_dtype(self.device)
        self.base_model, self.controlnet_kind = base_model, controlnet
        self.spec = _spec(base_model)
        self.unet_cfg = unet_cfg or UNET_CONFIGS[base_model]
        self.vae_cfg = vae_cfg or self.spec.vae_cfg
        self.text_cfgs = tuple(text_cfgs or self.spec.text_cfgs)
        self.tokenizer = default_tokenizer(weights_dir)
        self.scheduler = get_scheduler(sampler, self.spec.scheduler_cfg, self.device)
        self.latent_factor = 2 ** (len(self.vae_cfg.block_out_channels) - 1)

        dev, dt = self.device, self.dtype
        gn, mk = pallas_group_norm, attention_megakernel
        # the reference upcasts only the XL VAE (upcast_vae, run_aug/run_aug.py:189)
        fp32_vae = dt == torch.float32 or os.environ.get("SASPA_XL_VAE_FP32", "") == "1"
        self.vae_dtype = torch.float32 if self.spec.is_xl and fp32_vae else dt
        self.params = {
            "text": [CLIPTextEncoder(c, dt, dev) for c in self.text_cfgs],
            "unet": UNet2DCondition(self.unet_cfg, dt, dev, pallas_group_norm=gn, attention_megakernel=mk),
            "vae": AutoencoderKL(self.vae_cfg, self.vae_dtype, dev, pallas_group_norm=gn),
        }
        if controlnet:
            self.params["controlnet"] = ControlNet(self.unet_cfg, dt, dev, pallas_group_norm=gn,
                                                   attention_megakernel=mk)
        if controlnet == "hed":
            self.params["hed"] = HED(dt, dev)
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
        seeds = {"unet": seed, "vae": seed + 1, "controlnet": seed + 7, "hed": seed + 13}
        for name in names:
            if name == "text":
                for i, te in enumerate(self.params["text"]):
                    init_weights(te, seed + 2 + i)
            else:
                init_weights(self.params[name], seeds[name],
                             zero_prefixes=ZERO_INIT_PREFIXES if name == "controlnet" else ())

    def load_flax_params(self, flax_params) -> None:
        """Loads a flax param tree (numpy leaves) strictly: one subtree per
        model of the pipeline, every key."""
        sds = params_from_flax(flax_params)
        if set(sds) != set(self.params) or len(sds["text"]) != len(self.params["text"]):
            raise KeyError(f"flax subtrees {sorted(sds)} do not match the pipeline's {sorted(self.params)}")
        for k, sd in sds.items():
            for mod, msd in (zip(self.params[k], sd) if k == "text" else [(self.params[k], sd)]):
                mod.load_state_dict(msd, strict=True)
        self.weights_loaded = True

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

    def make_time_ids(self, b: int, height: int, width: int, negative: bool = False) -> torch.Tensor:
        """SDXL's time ids, (B, n) f32: for the base models (original h, w,
        crop top, left, target h, w), the prompt's and the negative's alike;
        the refiner puts the aesthetic score in place of the target pair, 6.0
        for the prompt and 2.5 for the negative (diffusers' XL img2img
        defaults)."""
        if self.base_model == "sd_xl-refiner":
            row = [height, width, 0, 0, 2.5 if negative else 6.0]
        else:
            row = [height, width, 0, 0, height, width]
        return torch.tensor([row], dtype=torch.float32, device=self.device).repeat(b, 1)

    def _conditions(self, text_params, ids, neg_ids, height: int, width: int, do_cfg: bool):
        """The UNet's conditions of the prompt ids and, under CFG, of the
        negative ids: (ctx, nctx, ac, nac), nctx None without CFG; ac and nac
        SDXL's added conditions (the pooled embedding and the time ids), None
        for SD1.5."""
        ctx, pooled = self.encode_ids(text_params, ids)
        nctx = ac = nac = None
        if do_cfg:
            nctx, npooled = self.encode_ids(text_params, neg_ids)
        if self.spec.is_xl:
            ac = {"text_embeds": pooled, "time_ids": self.make_time_ids(ctx.shape[0], height, width)}
            if do_cfg:
                nac = {"text_embeds": npooled, "time_ids": self.make_time_ids(ctx.shape[0], height, width, True)}
        return ctx, nctx, ac, nac

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
            ctx, nctx, ac, nac = self._conditions(params["text"], ids, neg_ids, height, width, do_cfg)
            return denoise(params, ctx, nctx, src_images, latents, return_images, ac, nac)

        return fused

    def _denoise(self, height: int, width: int, num_inference_steps: int, guidance_scale: float,
                 controlnet_scale: float, canny_low: float, canny_high: float):
        """The fused function's part after the text towers:
        fn(params, ctx, nctx, src_images, latents, return_images, ac, nac)
        -> uint8 images (and the [0, 1] f32 images): the control image on the
        device, the CFG DDIM loop, VAE decode, quantisation.  nctx is None without CFG; ac and
        nac are SDXL's added conditions of the prompt and the negative."""
        timesteps = self.scheduler.timesteps(num_inference_steps)

        def denoise(params, ctx, nctx, src_images, latents, return_images, ac=None, nac=None):
            control = self.control_from_src(src_images, height, width, canny_low, canny_high)
            lat = torch.as_tensor(latents, device=self.device).float()
            out = self._sample(params, lat, ctx, nctx, timesteps, guidance_scale=float(guidance_scale),
                               control_image=control, controlnet_scale=float(controlnet_scale), added_cond=ac,
                               uncond_added_cond=nac)
            u8 = quantize(out)
            return (u8, out) if return_images else u8

        return denoise

    def control_from_src(self, src_images, height: int, width: int, canny_low: float = 120.0,
                         canny_high: float = 200.0) -> Optional[torch.Tensor]:
        """The ControlNet's conditioning image of (B, H, W, 3) sources in [0,
        255] (uint8 or float) on the pipeline's device: Canny edges, or HED's
        edges of the sources / 255 in f32, nearest-resized to latent size * 8
        (the identity for the SD VAEs), or None without a ControlNet."""
        if self.controlnet_kind is None:
            return None
        # uint8 sources: values 0-255 are exact in f32, so the cast is exact
        src = torch.as_tensor(src_images, device=self.device).float()
        if self.controlnet_kind == "hed":
            control = hed_control_image(self.params["hed"], src / 255.0)
        else:
            control = canny_control_image(src, canny_low, canny_high)
        lf = self.latent_factor
        ch, cw = (height // lf) * 8, (width // lf) * 8
        return control if (ch, cw) == (height, width) else nearest_resize(control, ch, cw)

    @torch.no_grad()
    def encode_mean(self, images) -> torch.Tensor:
        """(B, H, W, 3) images in [0, 1] -> the VAE encoder's unscaled
        posterior mean, NCHW (B, 4, H/8, W/8) in the VAE's dtype."""
        x = torch.as_tensor(images, device=self.device).float() * 2.0 - 1.0
        return self.params["vae"].encode(x.permute(0, 3, 1, 2))[0]

    @torch.no_grad()
    def encode_image(self, images) -> torch.Tensor:
        """(B, H, W, 3) images in [0, 1] -> the scaled posterior mean
        z0 = mean * scaling_factor, (B, H/8, W/8, 4) in the VAE's dtype."""
        return (self.encode_mean(images) * self.vae_cfg.scaling_factor).permute(0, 2, 3, 1)

    @torch.no_grad()
    def generate(self, prompts, latents, height: int = 512, width: int = 512, num_inference_steps: int = 30,
                 guidance_scale: float = 7.5, negative_prompt: Optional[str] = NEGATIVE_PROMPT, control_image=None,
                 controlnet_scale: float = 0.75, init_image=None, sdedit_strength: float = 0.85, token_ids=None,
                 negative_token_ids=None, image_guidance_scale: float = 1.3) -> torch.Tensor:
        """Batched text(+control) -> image, or SDEdit from init_image (B, H, W,
        3) in [0, 1] when one is given: (B, H, W, 3) f32 images in [0, 1] on
        the pipeline's device.  latents: the (B, H/8, W/8, 4) initial noise (for SDEdit the noise added to z0);
        control_image: control_from_src's; token_ids / negative_token_ids:
        (B, 77) ids instead of the tokenizer's.  InstructPix2Pix (`ip2p`)
        edits init_image instead: its unscaled posterior mean is the image
        condition, the loop runs every step from the noise, under 3-way
        guidance when guidance_scale > 1 and image_guidance_scale >= 1
        (diffusers' rule), else one forward a step."""
        is_ip2p = self.base_model == "ip2p"
        do_cfg = guidance_scale > 1.0 and (not is_ip2p or image_guidance_scale >= 1.0)
        ids = token_ids if token_ids is not None else self.tokenizer(list(prompts), pad="eot")
        if do_cfg and negative_token_ids is None:
            negative_token_ids = self.tokenizer([negative_prompt or ""] * len(prompts), pad="eot")
        ctx, nctx, ac, nac = self._conditions(self.params["text"], ids, negative_token_ids, height, width, do_cfg)
        timesteps = self.scheduler.timesteps(num_inference_steps)
        lat = torch.as_tensor(latents, device=self.device).float()
        if is_ip2p:
            if init_image is None:
                raise ValueError("ip2p needs the image to edit (init_image)")
            return self._sample(self.params, lat, ctx, nctx, timesteps, guidance_scale=float(guidance_scale),
                                control_image=control_image, added_cond=ac,
                                image_latents=self.encode_mean(init_image).permute(0, 2, 3, 1),
                                image_guidance_scale=float(image_guidance_scale))
        if init_image is not None:
            timesteps = timesteps[sdedit_start_step(num_inference_steps, sdedit_strength):]
            lat = self.scheduler.add_noise(self.encode_image(init_image), lat, timesteps[0])
        return self._sample(self.params, lat, ctx, nctx, timesteps, guidance_scale=float(guidance_scale),
                            control_image=control_image, controlnet_scale=float(controlnet_scale), added_cond=ac,
                            uncond_added_cond=nac)


def init_pipeline(base_model: str, controlnet: Optional[str], SDEdit: bool = False, sampler: str = "ddim",
                  weights_dir: Optional[str] = None, dtype: Optional[torch.dtype] = None,
                  device=None) -> DiffusionPipeline:
    """Name-compatible with the reference's init_pipeline (run_aug/run_aug.py:128)
    and the JAX package's: SD1.5, SD2.1, SDXL, SDXL-Turbo or BLIP-Diffusion,
    with a canny or HED ControlNet or none, text to image or SDEdit, BLIP-Diffusion's
    inversion edit, and InstructPix2Pix without a ControlNet; DDIM; loaded
    from the public files under weights_dir, what it lacks takes the seeded
    random init (seed 0).  SDEdit only selects
    the model and the JAX package's refusals: any DiffusionPipeline runs
    SDEdit when its `generate` is given an init_image."""
    if base_model in BLIP_BASE_MODELS:
        if SDEdit and base_model != "blip_diffusion-edit":
            # the JAX package's refusal: the reference's blip + SDEdit call passes
            # arguments its BLIP pipelines do not declare
            raise ValueError("SDEdit is not supported with blip_diffusion; use "
                             "base_model='blip_diffusion-edit' for the inversion-edit path")
        # the edit path takes no ControlNet (the reference's edit() call has no conditioning image)
        controlnet = None if base_model == "blip_diffusion-edit" else controlnet
        from saspa_tpu_torch.models.blip_diffusion import BlipDiffusionPipeline

        return BlipDiffusionPipeline(controlnet=controlnet, sampler=sampler, dtype=dtype, device=device,
                                     weights_dir=weights_dir, init_seed=0)
    if base_model == "ip2p" and controlnet is not None:
        raise ValueError("ip2p does not support a ControlNet")
    if base_model == "sd_xl" and SDEdit and controlnet is None:
        base_model = "sd_xl-refiner"  # the reference's sd_xl img2img runs the refiner (run_aug/run_aug.py:149-151)
    return DiffusionPipeline(base_model, controlnet=controlnet, sampler=sampler, dtype=dtype, device=device,
                             weights_dir=weights_dir, init_seed=0)
