"""Where each public checkpoint lies in a `--weights_dir` tree, and which
files each model family needs.

The tree is the one tools/weights_day.py reads with --src_dir: the public
files as they are published, found by glob patterns tried in order, the
first pattern with a hit winning and, within it, the first file in sorted
order (`find_source`, weights_day's `_find_src`).  The patterns are
weights_day's (`default_parts`) for the families the port has, plus two
the JAX package loads without a weights_day part: the SDXL canny
ControlNet (`controlnet_canny_xl/`, saspa_tpu/diffusion/pipelines.py:314)
and SDXL base (`sd_xl/`, for `--base_model sd_xl`), and SD2.1's UNet, VAE
and text tower (`sd_v2.1/`, HF's 23-layer CLIPTextModel).  The HED
ControlNet is SD1.5's (`controlnet_hed_sd15/`) and its annotator is
controlnet_aux's `ControlNetHED.pth` (weights_day's `hed`).  No public file
rule exists, in either package, for an SD2.1 ControlNet or an XL HED
ControlNet: `controlnet_part` refuses both.  The SDXL refiner
(`--base_model sd_xl --sdedit --controlnet none`) is weights_day's
`sd_xl-refiner`: `*xl-refiner*/unet/`, SDXL's VAE and the bigG tower.  The CLIP tokenizer's
merges.txt and BLIP's WordPiece vocab.txt stay under `tokenizer/`, where
both packages look for them; the released WSDAN-CAL baselines under
`checkpoints/<dataset>/`, one `.pth` each (the reference's rule).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class Part:
    name: str
    kind: str  # the converter (weights/convert.py)
    srcs: Tuple[str, ...]  # glob patterns under the tree, first hit wins


PARTS: Dict[str, Part] = {p.name: p for p in [
    # SD1.5 (planes' recipe)
    Part("sd15_unet", "unet", ("sd_v1.5/unet/*.safetensors", "*stable-diffusion-v1-5*/unet/*.safetensors")),
    Part("sd15_vae", "vae", ("sd_v1.5/vae/*.safetensors", "*stable-diffusion-v1-5*/vae/*.safetensors")),
    Part("sd15_text", "clip_text",
         ("sd_v1.5/text_encoder/*.safetensors", "*stable-diffusion-v1-5*/text_encoder/*.safetensors")),
    Part("controlnet_canny_sd15", "controlnet",
         ("*control_v11p_sd15_canny*/*.safetensors", "controlnet_canny/*.safetensors",
          "controlnet_canny_sd15/*.safetensors")),
    Part("controlnet_hed_sd15", "controlnet",
         ("controlnet_hed_sd15/*.safetensors", "*sd-controlnet-hed*/*.safetensors")),
    Part("hed", "hed", ("ControlNetHED.pth", "*Annotators*/ControlNetHED.pth")),
    # SD2.1 (--base_model sd_v2.1): OpenCLIP-H's tower as HF's 23-layer CLIPTextModel
    Part("sd21_unet", "unet", ("sd_v2.1/unet/*.safetensors", "*stable-diffusion-2-1*/unet/*.safetensors")),
    Part("sd21_vae", "vae", ("sd_v2.1/vae/*.safetensors", "*stable-diffusion-2-1*/vae/*.safetensors")),
    Part("sd21_text", "clip_text",
         ("sd_v2.1/text_encoder/*.safetensors", "*stable-diffusion-2-1*/text_encoder/*.safetensors")),
    # InstructPix2Pix (ALIA's editor for planes_biased): an 8-channel conv_in
    Part("ip2p_unet", "unet", ("*instruct-pix2pix*/unet/*.safetensors", "ip2p/unet/*.safetensors")),
    Part("ip2p_vae", "vae", ("*instruct-pix2pix*/vae/*.safetensors", "ip2p/vae/*.safetensors")),
    Part("ip2p_text", "clip_text",
         ("*instruct-pix2pix*/text_encoder/*.safetensors", "ip2p/text_encoder/*.safetensors")),
    # SDXL-Turbo (cub's recipe), SDXL base, the fp16-fix VAE both use
    Part("xl_unet", "unet", ("sdxl-turbo/unet/*.safetensors", "*sdxl-turbo*/unet/*.safetensors")),
    Part("xl_vae", "vae", ("sdxl-vae-fp16-fix/*.safetensors", "*sdxl*vae*fp16*fix*/*.safetensors")),
    Part("xl_text_l", "clip_text",
         ("sdxl-turbo/text_encoder/*.safetensors", "*sdxl-turbo*/text_encoder/*.safetensors")),
    Part("xl_text_bigg", "clip_text",
         ("sdxl-turbo/text_encoder_2/*.safetensors", "*sdxl-turbo*/text_encoder_2/*.safetensors")),
    Part("xlbase_unet", "unet", ("sd_xl/unet/*.safetensors", "*stable-diffusion-xl-base*/unet/*.safetensors")),
    Part("xlbase_text_l", "clip_text",
         ("sd_xl/text_encoder/*.safetensors", "*stable-diffusion-xl-base*/text_encoder/*.safetensors")),
    Part("xlbase_text_bigg", "clip_text",
         ("sd_xl/text_encoder_2/*.safetensors", "*stable-diffusion-xl-base*/text_encoder_2/*.safetensors")),
    Part("controlnet_canny_xl", "controlnet",
         ("controlnet_canny_xl/*.safetensors", "*controlnet-canny-sdxl*/*.safetensors")),
    # the SDXL refiner (sd_xl + SDEdit without a ControlNet): its own UNet,
    # SDXL's fp16-fix VAE and the bigG tower
    Part("refiner_unet", "unet", ("*xl-refiner*/unet/*.safetensors",)),
    # BLIP-Diffusion (cars, dtd, compcars-parts): the qformer file also holds
    # the vision tower (vision_model.*), so one file feeds two converters
    Part("bd_unet", "unet", ("*blipdiffusion*/unet/*.safetensors", "blip_diffusion/unet/*.safetensors")),
    Part("bd_vae", "vae", ("*blipdiffusion*/vae/*.safetensors", "blip_diffusion/vae/*.safetensors")),
    Part("bd_text", "clip_text",
         ("*blipdiffusion*/text_encoder/*.safetensors", "blip_diffusion/text_encoder/*.safetensors")),
    Part("bd_qformer", "blip_diffusion",
         ("*blipdiffusion*/qformer/*.safetensors", "*blipdiffusion*/qformer/*.bin",
          "blip_diffusion/qformer/*.safetensors")),
    # the filter stage's scorers
    Part("clip_rn50", "clip_rn50", ("RN50.pt", "clip/RN50.pt")),
    Part("lpips", "lpips", ("lpips*.pth", "lpips/*.pth")),
    # the released WSDAN-CAL baselines, under the registry's dataset names
    *[Part(f"cal_{name}", "cal", (f"checkpoints/{name}/*.pth", f"cal/{ds}/*.pth", f"*cal*{ds}*.pth"))
      for name, ds in (("planes", "planes"), ("cars", "cars"), ("cub", "cub"), ("dtd", "dtd"),
                       ("compcars", "compcars-parts"))],
]}

# the pipeline's model -> part(s), per base model (weights_day's COMPOSE);
# blip_diffusion-controlnet shares blip_diffusion's weights
FAMILIES: Dict[str, Dict[str, object]] = {
    "sd_v1.5": {"unet": "sd15_unet", "vae": "sd15_vae", "text": ("sd15_text",)},
    "sd_v2.1": {"unet": "sd21_unet", "vae": "sd21_vae", "text": ("sd21_text",)},
    "ip2p": {"unet": "ip2p_unet", "vae": "ip2p_vae", "text": ("ip2p_text",)},
    "sd_xl-turbo": {"unet": "xl_unet", "vae": "xl_vae", "text": ("xl_text_l", "xl_text_bigg")},
    "sd_xl": {"unet": "xlbase_unet", "vae": "xl_vae", "text": ("xlbase_text_l", "xlbase_text_bigg")},
    "sd_xl-refiner": {"unet": "refiner_unet", "vae": "xl_vae", "text": ("xl_text_bigg",)},
    "blip_diffusion": {"unet": "bd_unet", "vae": "bd_vae", "text": ("bd_text",), "blip": "bd_qformer"},
}
CONTROLNETS = {("canny", False): "controlnet_canny_sd15", ("canny", True): "controlnet_canny_xl",
               ("hed", False): "controlnet_hed_sd15"}


def controlnet_part(base_model: str, kind: str, is_xl: bool) -> str:
    """The part of a pipeline's ControlNet, or a FileNotFoundError naming
    the file no rule provides: an SD2.1 ControlNet (SD1.5's, which the JAX
    package would load there, has a 768-wide context and conv projections)
    and an XL HED ControlNet."""
    if base_model == "sd_v2.1":
        raise FileNotFoundError(f"no file rule for an SD2.1 {kind} ControlNet (controlnet_{kind}_sd21): SD1.5's "
                                f"controlnet_{kind}_sd15 does not fit SD2.1's UNet (cross-attention 1024, linear "
                                "projections); run SD2.1 with --controlnet none, or without --weights_dir")
    part = CONTROLNETS.get((kind, is_xl))
    if part is None:
        raise FileNotFoundError(f"no file rule for a{'n XL' if is_xl else ''} {kind} ControlNet "
                                f"(controlnet_{kind}_{'xl' if is_xl else 'sd15'})")
    return part


def family_of(base_model: str) -> str:
    return "blip_diffusion" if base_model.startswith("blip_diffusion") else base_model


def find_source(weights_dir, part: str) -> Optional[Path]:
    """The file of `part` under the tree, or None."""
    root = Path(weights_dir)
    for pat in PARTS[part].srcs:
        hits = sorted(p for p in root.glob(pat) if p.is_file())
        if hits:
            return hits[0]
    return None
