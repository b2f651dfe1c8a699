"""Classifier-free-guidance sampling loop (counterpart of saspa_tpu/diffusion/sampler.py).

2-way CFG with the shared prefix: the UNet and ControlNet take the B-sized
latent against the 2B [uncond, cond] context and fork to 2B at their first
cross-attention.  Not for SDXL: its added conditions enter the time
embedding, which feeds every resnet, so under CFG the latents, the
ControlNet's conditioning embedding and the [uncond, cond] added conditions
go in at 2B; with cfg_full_batch (SASPA_CFG_FULL_BATCH=1) every family
does so.  The ControlNet conditioning embedding is computed once, before
the step loop, on the B control images, and tiled.  InstructPix2Pix
(`image_latents` given) runs 3-way guidance with no shared prefix: the
latents at 3B against the [cond, uncond, uncond] context, each third's
input the latents concatenated on the channel axis with the image latents
of [img, img, 0] (diffusers' order), eps = eps_u + gs (eps_t - eps_i) +
igs (eps_i - eps_u); without guidance one forward on [lat, img] against
the cond context.  The scheduler (DDIM or UniPC) carries its state from
step to step as the JAX package's scan does (`init_state`, then `step(state,
...)`); both schedulers' scale_model_input is the identity, so the model
input is the latents themselves.  Latents, control images, image latents
and outputs are NHWC at this boundary, NCHW inside.
"""

from __future__ import annotations

from typing import Optional

import torch


def make_sample_loop(unet_apply, scheduler, controlnet_apply=None, vae_decode=None, vae_scaling: float = 0.18215,
                     controlnet_embed=None, cfg_full_batch: bool = False):
    """unet_apply(params_unet, lat, t, ctx, added_cond, down_res, mid_res) -> eps (f32)
    controlnet_apply(params_cn, lat, t, ctx, cond_emb, scale, added_cond) -> (down_res, mid_res)
    controlnet_embed(params_cn, cond_img) -> cond embedding
    vae_decode(params_vae, z) -> images in [-1, 1]
    cfg_full_batch: no CFG shared prefix, the model input at 2B under CFG."""

    @torch.no_grad()
    def sample(params: dict, latents, context, uncond_context: Optional[torch.Tensor], timesteps,
               guidance_scale: float, control_image=None, controlnet_scale: float = 1.0,
               added_cond: Optional[dict] = None, uncond_added_cond: Optional[dict] = None,
               image_latents: Optional[torch.Tensor] = None, image_guidance_scale: float = 1.5):
        """latents (B, h, w, 4) f32; context (B, 77, D); timesteps: descending
        ints; added_cond / uncond_added_cond: SDXL's {"text_embeds",
        "time_ids"} of the prompt and the negative prompt; image_latents (B,
        h, w, 4): InstructPix2Pix's image condition.  Returns (B, H, W, 3)
        images in [0, 1] (or the final NHWC latents without a decoder)."""
        do_cfg = uncond_context is not None
        do_ip2p = image_latents is not None
        if do_ip2p:
            if control_image is not None or added_cond is not None:
                raise ValueError("ip2p does not support control_image/added_cond conditioning")
            img = image_latents.float().permute(0, 3, 1, 2)  # JAX's concatenate promotes to f32
            ctx = torch.cat([context, uncond_context, uncond_context], dim=0) if do_cfg else context
            img_lat = torch.cat([img, img, torch.zeros_like(img)], dim=0) if do_cfg else img
            n_rep = 3 if do_cfg else 1
        else:
            ctx = torch.cat([uncond_context, context], dim=0) if do_cfg else context
            # 1: the shared prefix forks inside the network
            n_rep = 2 if do_cfg and (added_cond is not None or cfg_full_batch) else 1
        ac = added_cond
        if do_cfg and added_cond is not None:
            ac = {k: torch.cat([uncond_added_cond[k], added_cond[k]], dim=0) for k in added_cond}
        lat = latents.float().permute(0, 3, 1, 2)  # channels-last in memory, as the convs keep it
        ts = [int(t) for t in timesteps]
        prev_ts = ts[1:] + [-1]
        state = scheduler.init_state(len(ts), tuple(lat.shape))

        cond_emb = None
        use_cn = controlnet_apply is not None and control_image is not None
        if use_cn:
            cond_emb = controlnet_embed(params["controlnet"], control_image.permute(0, 3, 1, 2))
            if n_rep > 1:
                cond_emb = torch.cat([cond_emb] * n_rep, dim=0)

        for t, prev_t in zip(ts, prev_ts):
            model_in = torch.cat([lat] * n_rep, dim=0) if n_rep > 1 else lat
            if do_ip2p:
                model_in = torch.cat([model_in, img_lat], dim=1)
            down_res = mid_res = None
            if use_cn:
                down_res, mid_res = controlnet_apply(params["controlnet"], model_in, t, ctx, cond_emb,
                                                     controlnet_scale, ac)
            eps = unet_apply(params["unet"], model_in, t, ctx, ac, down_res, mid_res)
            if do_ip2p and do_cfg:
                eps_t, eps_i, eps_u = eps.chunk(3, dim=0)
                eps = eps_u + guidance_scale * (eps_t - eps_i) + image_guidance_scale * (eps_i - eps_u)
            elif do_cfg:
                eps_u, eps_c = eps.chunk(2, dim=0)
                eps = eps_u + guidance_scale * (eps_c - eps_u)
            state, lat = scheduler.step(state, eps, t, prev_t, lat)

        if vae_decode is None:
            return lat.permute(0, 2, 3, 1)
        images = vae_decode(params["vae"], lat / vae_scaling)
        return torch.clamp(images * 0.5 + 0.5, 0.0, 1.0).permute(0, 2, 3, 1)

    return sample
