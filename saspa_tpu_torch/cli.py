"""Command-line interface of the port (counterpart of saspa_tpu/cli.py).

    python -m saspa_tpu_torch.cli gen --dataset planes --resolution 1024 --skip_filter

`gen` takes the JAX package's flags and builds the same GenerationConfig,
then runs the port's `run_generation` on the card.  Ported so far: SD1.5
with a canny ControlNet (or none), DDIM, without the filter stage
(`--skip_filter`); the presets and filtering come with the filter slice
(ROADMAP Queue 1 item 10), the other subcommands with later slices.
"""

from __future__ import annotations

import argparse
import logging


def _add_gen(sub):
    p = sub.add_parser("gen", help="generate augmentations (run_aug equivalent)")
    p.add_argument("--dataset", default="planes")
    p.add_argument("--base_model", default=None, help="default: sd_v1.5 for planes, blip_diffusion otherwise")
    p.add_argument("--controlnet", default="canny", choices=["canny", "hed", "none"])
    p.add_argument("--sdedit", action="store_true")
    p.add_argument("--sdedit_strength", type=float, default=0.85)
    p.add_argument("--num_per_image", type=int, default=2)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--prompt_type", default="gpt-meta_class")
    p.add_argument("--no_sub_class", action="store_true")
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--num_inference_steps", type=int, default=30)
    p.add_argument("--sampler", default="ddim", choices=["ddim", "unipcmultistep"])
    p.add_argument("--controlnet_scale", type=float, default=0.75)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--weights_dir", default=None)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--skip_filter", action="store_true")
    p.add_argument("--version", default="v1")
    p.add_argument("--preset", default=None, choices=["real_guidance", "alia"],
                   help="baseline presets (run_aug_real_guidance.py equivalents)")
    return p


def gen_config(args):
    """The GenerationConfig of the gen flags (saspa_tpu/cli.py:188-208)."""
    from saspa_tpu_torch.utils.config import GenerationConfig

    base_model = args.base_model or ("sd_v1.5" if args.dataset == "planes" else "blip_diffusion")
    return GenerationConfig(
        dataset=args.dataset,
        base_model=base_model,
        controlnet=None if args.controlnet == "none" else args.controlnet,
        sdedit=args.sdedit,
        sdedit_strength=args.sdedit_strength,
        num_per_image=args.num_per_image,
        seed=args.seed,
        prompt_type=args.prompt_type,
        prompt_with_sub_class=not args.no_sub_class,
        use_artistic_prompts=base_model == "sd_v1.5",
        resolution=args.resolution,
        guidance_scale=args.guidance_scale,
        num_inference_steps=args.num_inference_steps,
        sampler=args.sampler,
        controlnet_conditioning_scale=args.controlnet_scale,
        batch_size=args.batch_size,
        weights_dir=args.weights_dir,
        debug=args.debug,
        version=args.version,
    )


def cmd_gen(args):
    from saspa_tpu_torch.gen.driver import run_generation

    if args.preset is not None:
        raise NotImplementedError(f"--preset {args.preset} comes with the filter slice (ROADMAP Queue 1 item 10)")
    if not args.skip_filter:
        raise NotImplementedError("filtering the generated images comes with the filter slice "
                                  "(ROADMAP Queue 1 item 10); pass --skip_filter")
    return run_generation(gen_config(args))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="saspa_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    _add_gen(sub)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    return {"gen": cmd_gen}[args.command](args)


if __name__ == "__main__":
    main()
