"""Command-line interface of the port (counterpart of saspa_tpu/cli.py).

    python -m saspa_tpu_torch.cli gen --dataset planes --resolution 1024
    python -m saspa_tpu_torch.cli filter --dataset planes --aug_folder DIR
    python -m saspa_tpu_torch.cli merge-jsons --jsons A.json B.json --output OUT.json
    python -m saspa_tpu_torch.cli train --dataset planes --aug_json AUG.json --aug_sample_ratio 0.4 \
        --limit_aug_per_image 2 --special_aug classic
    python -m saspa_tpu_torch.cli eval-biased --ckpt_folder LOGDIR
    python -m saspa_tpu_torch.cli prep-captions --dataset planes --images A.jpg B.png --output CAPTIONS.json \
        [--questions "what color is the plane?"] --weights_dir TREE
    python -m saspa_tpu_torch.cli prep-prompts --dataset planes --num 100 --output_path DIR --weights_dir TREE

`gen` takes the JAX package's flags and builds the same GenerationConfig,
then runs the port's `run_generation_and_filter` on the card (the CLIP
semantic filter and the baseline's top-10 confidence filter), or
`run_generation` with `--skip_filter`.  `filter` rebuilds the aug-JSON of a
folder of generated images (`--lpips_min`/`--lpips_max`: the LPIPS filter);
`merge-jsons` merges aug-JSONs.  `gen --max_items N` (the port's own
flag) generates only the first N items of the worklist.  `train` trains
the WSDAN-CAL classifier on the originals mixed with the aug-JSON's images
(`fgvc/runner.py::run_training`), with the JAX CLI's flags; `--ckpt` takes
the port's checkpoint or a released WSDAN-CAL .pth; `--gpu_id` is accepted
and ignored, as there; `--use_target_soft_cross_entropy` blends in the
CLIP RN50 teacher's soft targets (planes and cars); `--net` takes
resnet101 (the default), resnet50, resnet50_cbam, resnet101_cbam,
inception_mixed_6e and inception_mixed_7c, as `eval-biased --net` does;
`--plot_per_class_acc` writes the per-class accuracy plots (matplotlib,
which the H100 machine lacks: there the flag fails before the first
step).  `eval-biased` scores
every checkpoint of a folder on planes_biased's test split, in domain and
out of domain (`fgvc/val_biased.py`).  `--weights_dir` names a tree of the
public checkpoint files (README; `weights/sources.py`); without it every
model takes a seeded init.  Every generation family of the JAX CLI runs:
SD1.5 (planes' default), SD2.1 (`--base_model sd_v2.1`), BLIP-Diffusion
(the default of cars, dtd and compcars-parts) and SDXL-Turbo (cub's: 2
trailing DDIM steps, guidance 0), and SDXL under CFG (`--base_model sd_xl`),
each with a canny or HED ControlNet (`--controlnet hed`) or none, text to
image or SDEdit (`--sdedit [--sdedit_strength s]`), on DDIM
or UniPC (`--sampler unipcmultistep`); the SDXL refiner, which `--base_model
sd_xl --sdedit --controlnet none` runs, as in the JAX package;
BLIP-Diffusion's inversion edit (`--base_model blip_diffusion-edit`); and
the baseline presets `--preset real_guidance` and `--preset alia` with the
JAX CLI's filter recipes (ALIA on planes_biased runs InstructPix2Pix).
Sources may be PNG or JPEG (decoded without PIL, `gen/jpeg.py`).
SASPA_XL_VAE_FP32=1 runs the XL families' VAE in f32, as in the JAX
package.  The offline prompt tools take the JAX CLI's flags and write its
files: `prep-captions` BLIP-captions the images (LAVIS's caption model;
with `--questions`, BLIP VQA answers each question beside the caption) into
the captions JSON that `--prompt_type captions` reads; `prep-prompts`
writes the keytotext T5's sentence pool LE_{num}_{dataset}_all_classes_
{bool}.json under --output_path and prints its path.  Both read the public
files (LAVIS's .pth, the T5's HF files) under --weights_dir (else
$SASPA_WEIGHTS_DIR, else ./weights) and raise without them.
"""

from __future__ import annotations

import argparse
import logging


def _add_gen(sub):
    p = sub.add_parser("gen", help="generate augmentations (run_aug equivalent)")
    p.add_argument("--dataset", default="planes")
    p.add_argument("--base_model", default=None,
                   help="default: sd_v1.5 for planes, sd_xl-turbo for cub, blip_diffusion otherwise")
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
    p.add_argument("--max_items", type=int, default=None,
                   help="generate at most this many of the worklist's items (not in the JAX CLI)")
    return p


def _add_filter(sub):
    p = sub.add_parser("filter", help="build the aug-JSON from a folder of generated images")
    p.add_argument("--dataset", required=True)
    p.add_argument("--aug_folder", required=True)
    p.add_argument("--lpips_min", type=float, default=None)
    p.add_argument("--lpips_max", type=float, default=None)
    p.add_argument("--clip_filtering", default=None, choices=[None, "per_class"])
    p.add_argument("--clip_filtering_discount", type=float, default=1.0)
    p.add_argument("--no_semantic_filtering", action="store_true")
    p.add_argument("--no_model_confidence", action="store_true")
    p.add_argument("--conf_top_k", type=int, default=10)
    p.add_argument("--alia_conf_filtering", action="store_true")
    p.add_argument("--weights_dir", default=None)
    p.add_argument("--batch_size", type=int, default=64)
    return p


def _add_train(sub):
    # flag names mirror fgvc/train.py:46-80, as the JAX CLI's
    p = sub.add_parser("train", help="train the WS-DAN/CAL classifier")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--gpu_id", type=int, default=0, help="accepted for parity; ignored")
    p.add_argument("--logdir", type=str, default="logs")
    p.add_argument("--dataset", type=str, default="planes")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--learning_rate", type=float, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--weight_decay", type=float, default=None)
    p.add_argument("--net", type=str, default="resnet101")
    p.add_argument("--aug_json", type=str, default=None)
    p.add_argument("--aug_sample_ratio", type=float, default=None)
    p.add_argument("--limit_aug_per_image", type=int, default=None)
    p.add_argument("--stop_aug_after_epoch", type=int, default=None)
    p.add_argument("--special_aug", type=str, default="classic")
    p.add_argument("--train_sample_ratio", type=float, default=1.0)
    p.add_argument("--dont_use_wsdan", action="store_true", default=False)
    p.add_argument("--use_cutmix", action="store_true", default=False)
    p.add_argument("--use_target_soft_cross_entropy", action="store_true", default=False)
    p.add_argument("--few_shot", type=int, default=None)
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--wandb", action="store_true", default=False)
    p.add_argument("--plot_per_class_acc", action="store_true", default=False,
                   help="write samples-per-class vs class-accuracy scatter PNGs each validation")
    p.add_argument("--weights_dir", default=None, help="converted-checkpoint dir for the CLIP soft-CE teacher")
    return p


def _add_eval_biased(sub):
    p = sub.add_parser("eval-biased", help="OOD/ID eval on planes_biased (val_biased equivalent)")
    p.add_argument("--ckpt_folder", required=True)
    p.add_argument("--net", default="resnet101")
    p.add_argument("--batch_size", type=int, default=16)
    return p


def _add_merge(sub):
    p = sub.add_parser("merge-jsons", help="merge aug-JSONs")
    p.add_argument("--jsons", nargs="+", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--amount_per_json", type=int, default=None)
    return p


def _add_prep_captions(sub):
    p = sub.add_parser(
        "prep-captions",
        help="offline: BLIP-caption a dataset into the captions JSON "
             "(prompts_engineering/blip_utils.py equivalent)",
    )
    p.add_argument("--dataset", required=True)
    p.add_argument("--images", nargs="+", required=True, help="image paths to caption")
    p.add_argument("--output", required=True)
    p.add_argument("--questions", nargs="*", default=[])
    p.add_argument("--weights_dir", default=None)
    return p


def _add_prep_prompts(sub):
    p = sub.add_parser(
        "prep-prompts",
        help="offline: keytotext-T5 sentence pool with keyword filter "
             "(prompts_engineering/txt2sentance_prompts.py equivalent)",
    )
    p.add_argument("--dataset", required=True)
    p.add_argument("--num", type=int, default=100)
    p.add_argument("--output_path", required=True)
    p.add_argument("--all_classes", action="store_true")
    p.add_argument("--weights_dir", default=None)
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


def preset_config(args):
    """The GenerationConfig of --preset real_guidance or alia (saspa_tpu/cli.py:160-182)."""
    from saspa_tpu_torch.utils.config import GenerationConfig

    make = {"real_guidance": GenerationConfig.real_guidance, "alia": GenerationConfig.alia}[args.preset]
    return make(args.dataset, num_per_image=args.num_per_image, seed=args.seed, batch_size=args.batch_size,
                weights_dir=args.weights_dir, debug=args.debug, version=args.version)


# each preset's filter recipe, the JAX CLI's (saspa_tpu/cli.py:167-182)
PRESET_FILTERS = {
    "real_guidance": dict(clip_filtering="per_class", semantic_filtering=False,
                          model_confidence_based_filtering=False),
    "alia": dict(semantic_filtering=True, model_confidence_based_filtering=False, alia_conf_filtering=True),
}


def cmd_gen(args):
    from saspa_tpu_torch.gen.driver import run_generation, run_generation_and_filter

    cut = {} if args.max_items is None else {"max_items": args.max_items}
    if args.preset is not None:  # filters whatever --skip_filter says, as the JAX CLI
        return run_generation_and_filter(preset_config(args), **cut, **PRESET_FILTERS[args.preset])
    if args.skip_filter:
        return run_generation(gen_config(args), **cut)
    return run_generation_and_filter(gen_config(args), semantic_filtering=True,
                                     model_confidence_based_filtering=True, **cut)


def cmd_filter(args):
    from saspa_tpu_torch.filters.aug_json import create_json_of_image_name_to_augmented_images_paths

    path = create_json_of_image_name_to_augmented_images_paths(
        args.dataset,
        augmented_image_folder_path=args.aug_folder,
        lpips_min=args.lpips_min,
        lpips_max=args.lpips_max,
        clip_filtering=args.clip_filtering,
        clip_filtering_discount=args.clip_filtering_discount,
        semantic_filtering=not args.no_semantic_filtering,
        model_confidence_based_filtering=not args.no_model_confidence,
        conf_top_k=args.conf_top_k,
        alia_conf_filtering=args.alia_conf_filtering,
        weights_dir=args.weights_dir,
        batch_size=args.batch_size,
    )
    print(path)
    return path


def cmd_merge(args):
    from saspa_tpu_torch.filters.aug_json import merge_aug_jsons, merge_aug_jsons_with_amount_per_json

    if args.amount_per_json:
        return merge_aug_jsons_with_amount_per_json({j: args.amount_per_json for j in args.jsons}, args.output)
    return merge_aug_jsons(args.jsons, args.output)


def cmd_train(args, device=None):
    from saspa_tpu_torch.fgvc.runner import run_training

    return run_training(args, device=device)


def cmd_eval_biased(args, device=None):
    from saspa_tpu_torch.fgvc.val_biased import main as vb_main

    return vb_main(args.ckpt_folder, net=args.net, batch_size=args.batch_size, device=device)


def cmd_prep_captions(args, device=None):
    from saspa_tpu_torch.gen.caption_tools import write_captions_of_a_dataset_to_json

    return write_captions_of_a_dataset_to_json(args.dataset, args.images, args.output, questions=args.questions,
                                               weights_dir=args.weights_dir, device=device)


def cmd_prep_prompts(args, device=None):
    from saspa_tpu_torch.gen.caption_tools import generate_txt2sentence_prompts

    path = generate_txt2sentence_prompts(args.dataset, args.num, args.output_path, all_classes=args.all_classes,
                                         weights_dir=args.weights_dir, device=device)
    print(path)
    return path


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="saspa_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    _add_gen(sub)
    _add_filter(sub)
    _add_train(sub)
    _add_eval_biased(sub)
    _add_merge(sub)
    _add_prep_captions(sub)
    _add_prep_prompts(sub)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    return {"gen": cmd_gen, "filter": cmd_filter, "train": cmd_train, "eval-biased": cmd_eval_biased,
            "merge-jsons": cmd_merge, "prep-captions": cmd_prep_captions,
            "prep-prompts": cmd_prep_prompts}[args.command](args)


if __name__ == "__main__":
    main()
