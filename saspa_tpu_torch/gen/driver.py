"""Generation driver: batched, shardable, resumable (counterpart of saspa_tpu/gen/driver.py).

The reference's nested per-image/per-prompt loops (run_aug/run_aug.py:282-505)
become a flat worklist of (image, prompt) items that is
  * deduplicated against existing outputs (the reference's resume rule,
    run_aug/run_aug.py:430-432: same file names, so resumes interoperate);
  * sliced across processes by a stable ordinal (`torch.distributed` rank
    and world size when a process group is initialised, else one process);
  * bucketed by the resized source shape (a header read per file);
  * run in batches: the host reads and resizes the sources, the card runs
    Canny, the text tower(s), the CFG DDIM (or UniPC) loop and the VAE decode
    (`DiffusionPipeline.make_fused_generate`; SDXL-Turbo, cub's model, at
    its recipe's guidance scale 0 runs no negative tower), and the host
    writes the PNGs of batch i while the card works on batch i + 1.
    BLIP-Diffusion (`blip_diffusion[-controlnet]`) also reads each item's
    same-class subject image, writes it as `{stem}_subject_{i}.png`, and
    hands it at 224^2 to the fused function with the dataset's meta class
    as the subject category.
SDEdit (`cfg.sdedit`: the Real-Guidance and ALIA presets) and BLIP-Diffusion's
inversion edit (`blip_diffusion-edit`) take the unfused entry points,
`pipe.generate` with the source / 255 as the image to edit (and its canny
image from `pipe.control_from_src` with a ControlNet) and `pipe.edit` with
the source and the subject references, as the JAX driver does.
InstructPix2Pix (`ip2p`, ALIA's editor for planes_biased) takes
`pipe.generate` too, with the source / 255 as the image to edit, image
guidance 1.3 and 100 steps whatever cfg.num_inference_steps says (the JAX
driver's recipe, run_aug/run_aug.py:252-255).
Every item's noise derives from (seed, image index, prompt index) through
`utils.rng.item_normal`, jax.random.normal's draw in numpy, so results do not
depend on batch composition, shard count or resume point, and match the JAX
driver's.  Sources are read and PNGs written by `gen.image_io`; resizing is
`ops.image.resize_image`.  `run_generation_and_filter` then builds the
aug-JSON of the folder (`filters.aug_json`).  The families the port lacks
(SD2.1, HED) raise, naming ROADMAP Queue 1 item 12.
"""

from __future__ import annotations

import json
import logging
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from saspa_tpu_torch.gen.image_io import image_size, read_rgb, write_png
from saspa_tpu_torch.ops.canny import canny
from saspa_tpu_torch.ops.image import HWC3, pil_resize, resize_image, resize_shape_multiple_of_64
from saspa_tpu_torch.utils import rng as rngs
from saspa_tpu_torch.utils.config import MAX_FILENAME_LENGTH, GenerationConfig

MAX_ERRORS = 20  # runtime errors tolerated before the run stops (run_aug/run_aug.py:492-500)
IP2P_STEPS = 100  # ALIA's ip2p recipe (run_aug/run_aug.py:252-255)
IP2P_IMAGE_GUIDANCE = 1.3


@dataclass
class WorkItem:
    image_index: int
    image_path: str
    prompt_index: int
    prompt: str
    output_path: str
    subject_path: Optional[str] = None  # BLIP-diffusion same-class reference
    # position in the full pre-resume-skip worklist: the shard key, so a
    # process's share does not depend on which outputs already exist
    ordinal: int = 0


def _debug_paths(cfg: GenerationConfig, paths: List[str]) -> List[str]:
    """Debug-run image selection: the targeted files, else the first 4
    (run_aug/run_aug.py:351-355)."""
    if cfg.specific_file_strs:
        return [p for p in paths if any(s in p for s in cfg.specific_file_strs)]
    return paths[:4]


def build_worklist(cfg: GenerationConfig, ds_utils, engine, output_folder: str) -> List[WorkItem]:
    """Enumerate (image, prompt) items, skipping already-generated outputs."""
    items: List[WorkItem] = []
    paths = ds_utils.original_images_paths
    if cfg.debug:
        paths = _debug_paths(cfg, paths)

    ordinal = 0
    for index, source_image_path in enumerate(paths):
        stem = Path(source_image_path).stem
        for i in range(cfg.num_per_image):
            ordinal += 1
            prompt = engine.build(source_image_path, index, i)
            out = Path(output_folder) / f"{stem[:MAX_FILENAME_LENGTH]}_prompt_{prompt.replace('/', '-')}_{i}.png"
            if out.exists():
                continue
            subject = None
            if "blip_diffusion" in cfg.base_model and cfg.style_img_from_diff_img:
                same = ds_utils.get_image_path_with_same_class(source_image_path)
                subject = same[rngs.host_choice(len(same), cfg.seed, "subject_choice", index, i)]
            items.append(WorkItem(index, source_image_path, i, prompt, str(out), subject, ordinal - 1))
    return items


def _process_index_count() -> Tuple[int, int]:
    """(rank, world size) of an initialised torch.distributed group, else (0, 1)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _shard_for_host(items: List) -> List:
    """This process's share of a list.  WorkItems shard by their stable
    pre-skip `ordinal`, not by position in the resume-filtered list (which
    depends on when a process built it); plain sequences (the (index, path)
    pairs of the side files, never resume-filtered) shard by position."""
    idx, n = _process_index_count()
    if n == 1:
        return items
    if items and isinstance(items[0], WorkItem):
        return [it for it in items if it.ordinal % n == idx]
    return items[idx::n]


def _host_barrier(name: str) -> None:
    """Cross-process sync point (multi-process runs only)."""
    if _process_index_count()[1] > 1:
        torch.distributed.barrier()


def _bucket_by_shape(items: List[WorkItem], resolution: int) -> Dict[Tuple[int, int], List[WorkItem]]:
    """Bucket items by their resized shape; each distinct source file is
    read for its header only."""
    distinct = list({it.image_path: None for it in items})  # ordered dedup
    sizes = {p: image_size(p) for p in distinct}
    buckets: Dict[Tuple[int, int], List[WorkItem]] = {}
    for it in items:
        w, h = sizes[it.image_path]
        hh, ww, _ = resize_shape_multiple_of_64(h, w, resolution)
        buckets.setdefault((hh, ww), []).append(it)
    return buckets


def _save_source_and_control(cfg, indexed_paths, output_folder, device="cpu"):
    """_source.png per original, and _control.png (Canny edges, on `device`)
    for the first 10 images overall: `indexed_paths` carries (global index,
    path) pairs so the rule holds on a shard (run_aug/run_aug.py:377-378,
    441-442)."""
    for index, p in indexed_paths:
        stem = Path(p).stem[:MAX_FILENAME_LENGTH]
        src_out = Path(output_folder) / f"{stem}_source.png"
        ctrl_out = Path(output_folder) / f"{stem}_control.png"
        need_src = not src_out.exists()
        need_ctrl = cfg.controlnet == "canny" and index < 10 and not ctrl_out.exists()
        if not (need_src or need_ctrl):
            continue
        img = resize_image(read_rgb(p), cfg.resolution)
        if need_src:
            write_png(src_out, img)
        if need_ctrl:
            edges = canny(torch.as_tensor(img, device=device), cfg.low_threshold_canny, cfg.high_threshold_canny)
            write_png(ctrl_out, HWC3(edges.cpu().numpy()))


def _check_supported(cfg: GenerationConfig) -> None:
    """The JAX driver's refusals, and the port's of the families it lacks
    (also for an injected pipe)."""
    from saspa_tpu_torch.diffusion.pipelines import refuse_unported

    if cfg.base_model == "ip2p" and cfg.controlnet is not None:
        raise ValueError("ip2p does not support a ControlNet")
    if cfg.sdedit and "blip_diffusion" in cfg.base_model:
        raise ValueError("SDEdit is not supported with blip_diffusion; use "
                         "base_model='blip_diffusion-edit' for the inversion-edit path")
    edit = cfg.base_model == "blip_diffusion-edit"  # takes no ControlNet
    refuse_unported(cfg.base_model, None if edit else cfg.controlnet, cfg.sampler, cfg.sdedit)


def _subject_references(cfg: GenerationConfig, chunk: List[WorkItem], output_folder: str) -> np.ndarray:
    """BLIP-Diffusion's reference images of a batch, (B, 224, 224, 3) f32 in
    [0, 1], as the JAX driver makes them: the item's subject image (or its
    source) resized to cfg.resolution, / 255 in f32; `{stem}_subject_{i}.png`
    of (r * 255).astype(uint8) where it does not exist yet (a truncation, so
    x / 255 * 255 can come back as x - 1); then PIL's default resize of that
    uint8 image to 224^2, / 255."""
    refs = []
    for it in chunk:
        r = resize_image(read_rgb(it.subject_path or it.image_path), cfg.resolution).astype(np.float32) / 255.0
        u8 = (r * 255).astype(np.uint8)
        sp = Path(output_folder) / f"{Path(it.image_path).stem[:MAX_FILENAME_LENGTH]}_subject_{it.prompt_index}.png"
        if not sp.exists():
            write_png(sp, u8)
        refs.append(pil_resize(u8, (224, 224)))
    return np.stack(refs).astype(np.float32) / np.float32(255.0)


def run_generation(cfg: GenerationConfig, pipe=None, max_items: Optional[int] = None) -> str:
    """Generate augmentations; returns the output folder.  `pipe` can be
    injected (tests); otherwise `init_pipeline` builds it on the card."""
    from saspa_tpu_torch.data.registry import DS_UTILS_DICT
    from saspa_tpu_torch.diffusion.pipelines import quantize
    from saspa_tpu_torch.gen.prompts import PromptEngine

    cfg = cfg.with_dataset_overrides()
    _check_supported(cfg)  # also for an injected pipe
    ds_utils = DS_UTILS_DICT[cfg.dataset](print_func=logging.info)
    output_folder = cfg.output_folder(str(ds_utils.root_path))
    Path(output_folder).mkdir(parents=True, exist_ok=True)
    logging.info("Output folder: %s", output_folder)

    image_classes_dict = (
        ds_utils.get_image_stem_to_class_str_dict()
        if cfg.dataset in ("planes", "cars", "planes_biased")
        else ds_utils.get_image_path_to_class_str_dict()
    )
    engine = PromptEngine(cfg, ds_utils, image_classes_dict)

    # host-side time, reported in one JSON line at the end (side_files_s: the
    # _source/_control PNGs of every source of the split, before the batches)
    tele = {"worklist_s": 0.0, "decode_s": 0.0, "dispatch_s": 0.0, "fetch_s": 0.0, "png_s": 0.0}

    def _items_and_buckets():
        t = time.perf_counter()
        its = _shard_for_host(build_worklist(cfg, ds_utils, engine, output_folder))
        if max_items is not None:
            its = its[:max_items]
        out = its, _bucket_by_shape(its, cfg.resolution)
        tele["worklist_s"] = time.perf_counter() - t
        return out

    if pipe is None:
        # the worklist scan (resume stats, one header read per source)
        # overlaps the pipeline's construction
        from concurrent.futures import ThreadPoolExecutor

        from saspa_tpu_torch.diffusion.pipelines import init_pipeline

        with ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(_items_and_buckets)
            pipe = init_pipeline(cfg.base_model, cfg.controlnet, cfg.sdedit, cfg.sampler, cfg.weights_dir)
            items, buckets = fut.result()
    else:
        items, buckets = _items_and_buckets()
    logging.info("Work items after resume-skip/host-shard: %d", len(items))

    src_paths = ds_utils.original_images_paths
    if cfg.debug:
        src_paths = _debug_paths(cfg, src_paths)
    t = time.perf_counter()
    _save_source_and_control(cfg, _shard_for_host(list(enumerate(src_paths))), output_folder, pipe.device)
    tele["side_files_s"] = time.perf_counter() - t
    logging.info("Shape buckets: %s", {k: len(v) for k, v in buckets.items()})

    total, t0 = 0, time.time()
    num_errors = 0
    pending = None  # (chunk, n_real, device uint8): PNG encoding of batch i overlaps the card's batch i + 1

    def flush_pending():
        nonlocal pending, total
        if pending is None:
            return
        p_chunk, p_n, p_out = pending
        pending = None
        t = time.perf_counter()
        arr = p_out.cpu().numpy()  # waits for the card's batch
        tele["fetch_s"] += time.perf_counter() - t
        t = time.perf_counter()
        for it, img in zip(p_chunk[:p_n], arr[:p_n]):
            write_png(it.output_path, img)
        tele["png_s"] += time.perf_counter() - t
        total += p_n
        if "first_flush_t" not in tele:  # the steady rate excludes the first batch
            tele["first_flush_t"] = time.time() - t0
            tele["first_flush_items"] = total

    def count_error(what: str, e: Exception) -> bool:
        """Counts a runtime error; True once the run must stop."""
        nonlocal num_errors
        num_errors += 1
        logging.exception("runtime error %s (%d/%d errors): %s", what, num_errors, MAX_ERRORS, e)
        if num_errors > MAX_ERRORS:
            logging.error("Too many runtime errors, aborting generation")
            return True
        return False

    lf = pipe.latent_factor
    neg = [cfg.negative_prompt or ""] * cfg.batch_size
    is_blip = "blip_diffusion" in cfg.base_model
    is_edit = cfg.base_model == "blip_diffusion-edit"
    is_ip2p = cfg.base_model == "ip2p"
    use_fused = not (cfg.sdedit or is_edit or is_ip2p)  # these take the unfused entry points
    meta = ds_utils.meta_class  # BLIP's source and target subject category
    aborted = False  # MAX_ERRORS stops every bucket, not just the current one
    for (h, w), bucket_items in buckets.items():
        if aborted:
            break
        bs = cfg.batch_size
        if use_fused:
            fused = pipe.make_fused_generate(h, w, cfg.num_inference_steps, cfg.guidance_scale,
                                             cfg.controlnet_conditioning_scale, cfg.low_threshold_canny,
                                             cfg.high_threshold_canny)
        for lo in range(0, len(bucket_items), bs):
            chunk = bucket_items[lo:lo + bs]
            # pad the last batch to a full one (repeating its last item);
            # the padded outputs are discarded
            n_real = len(chunk)
            if n_real < bs:
                chunk = chunk + [chunk[-1]] * (bs - n_real)
            t_dec = time.perf_counter()
            srcs = []
            for it in chunk:
                img = resize_image(read_rgb(it.image_path), cfg.resolution)
                assert img.shape[:2] == (h, w), (img.shape, h, w)
                srcs.append(img)
            src = np.stack(srcs)  # uint8: the pipeline uploads it and casts on the card
            refs = _subject_references(cfg, chunk, output_folder) if is_blip else None
            tele["decode_s"] += time.perf_counter() - t_dec
            latents = np.stack([rngs.item_normal(cfg.seed, "noise", it.image_index, it.prompt_index,
                                                 shape=(h // lf, w // lf, 4)) for it in chunk])
            # dispatch this batch, then drain the previous one; separate error
            # scopes, so one failure skips one batch (run_aug/run_aug.py:492-500)
            dispatched = None
            t_disp = time.perf_counter()
            try:
                prompts = [it.prompt for it in chunk]
                if is_edit:
                    # the source inverted, then regenerated under the subject
                    # embeddings; the meta class is the source and the target subject
                    dispatched = quantize(pipe.edit(
                        torch.as_tensor(src, device=pipe.device).float() / 255.0, refs, prompts,
                        source_subject=meta, target_subject=meta, guidance_scale=cfg.guidance_scale,
                        num_inference_steps=cfg.num_inference_steps, negative_prompt=cfg.negative_prompt))
                elif is_ip2p:
                    dispatched = quantize(pipe.generate(
                        prompts, height=h, width=w, num_inference_steps=IP2P_STEPS,
                        guidance_scale=cfg.guidance_scale, negative_prompt=cfg.negative_prompt,
                        init_image=torch.as_tensor(src, device=pipe.device).float() / 255.0,
                        image_guidance_scale=IP2P_IMAGE_GUIDANCE, latents=latents))
                elif cfg.sdedit:
                    control = pipe.control_from_src(src, h, w, cfg.low_threshold_canny, cfg.high_threshold_canny)
                    dispatched = quantize(pipe.generate(
                        prompts, height=h, width=w, num_inference_steps=cfg.num_inference_steps,
                        guidance_scale=cfg.guidance_scale, negative_prompt=cfg.negative_prompt,
                        control_image=control, controlnet_scale=cfg.controlnet_conditioning_scale,
                        init_image=torch.as_tensor(src, device=pipe.device).float() / 255.0,
                        sdedit_strength=cfg.sdedit_strength, latents=latents))
                elif is_blip:
                    ids = pipe.build_subject_prompt_ids(prompts, meta)
                    cat_ids, cat_mask = pipe.bert_category_ids(meta, len(chunk))
                    dispatched = fused(pipe.params, ids, pipe.tokenizer(neg, pad="eot"), cat_ids, cat_mask, refs,
                                       src, latents)
                else:
                    dispatched = fused(pipe.params, pipe.tokenizer(prompts, pad="eot"), pipe.tokenizer(neg, pad="eot"),
                                       src, latents)
            except RuntimeError as e:
                if count_error("on batch", e):
                    aborted = True
                    break
            tele["dispatch_s"] += time.perf_counter() - t_disp
            try:
                flush_pending()
            except RuntimeError as e:
                if count_error("draining the previous batch", e):
                    aborted = True
                    break
            pending = (chunk, n_real, dispatched) if dispatched is not None else None
            if dispatched is not None and total % (bs * 4) < bs:
                logging.info("generated %d/%d items (%.2f img/s)", total, len(items),
                             total / max(time.time() - t0, 1e-9))

    try:
        flush_pending()
    except RuntimeError as e:
        count_error("draining the final batch", e)
    wall = time.time() - t0
    logging.info("Done Generating: %d items in %.1fs", total, wall)
    tele_out = {k: round(v, 2) for k, v in tele.items()}
    tele_out.update(total=total, wall_s=round(wall, 2), num_errors=num_errors)
    ff_t, ff_n = tele.get("first_flush_t"), tele.get("first_flush_items", 0)
    if ff_t is not None and total > ff_n and wall > ff_t:
        tele_out["steady_img_per_s"] = round((total - ff_n) / (wall - ff_t), 4)
    logging.info("generation telemetry: %s", json.dumps(tele_out))
    return output_folder


def run_generation_and_filter(cfg: GenerationConfig, filter_cfg=None, pipe=None, max_items: Optional[int] = None,
                              **filter_kw) -> str:
    """Generate, then build the aug-JSON (run_aug/run_aug.py:713-733);
    returns the JSON's path (the output folder after a debug run with
    `specific_file_strs`, which skips the JSON).

    max_items: run_generation's cut of this process's worklist.
    Filter options: the defaults, then `filter_cfg` (a FilterConfig or a
    dict; its `dataset` field gives way to cfg.dataset), then `filter_kw`.
    The filter runs on the injected pipe's device, else on the card.  With a
    process group, every rank generates its share, all meet at a barrier,
    and only rank 0 scores and writes the JSON; the other ranks return the
    same path (the JSON's name is a function of the filter flags)."""
    import dataclasses
    import inspect

    from saspa_tpu_torch.filters.aug_json import create_json_of_image_name_to_augmented_images_paths, \
        get_aug_json_path

    output_folder = run_generation(cfg, pipe=pipe, max_items=max_items)
    if cfg.debug and cfg.specific_file_strs:
        logging.info("Skipping json creation (SPECIFIC_FILE_STRs debug run)")
        return output_folder
    kw = dict(resize=(256, 256), clip_filtering_discount=1)
    if filter_cfg is not None:
        d = dataclasses.asdict(filter_cfg) if dataclasses.is_dataclass(filter_cfg) else dict(filter_cfg)
        d.pop("dataset", None)
        kw.update(d)
    kw.update(filter_kw)

    rank, world = _process_index_count()
    if world > 1:
        # every shard must be on disk before the folder is scored
        _host_barrier("saspa:generation_done")
        if rank != 0:
            folder = output_folder if str(output_folder).endswith("/images") else str(Path(output_folder) / "images")
            name_params = inspect.signature(get_aug_json_path).parameters
            flags = {k: v for k, v in kw.items() if k in name_params and k != "augmented_image_folder_path"}
            return get_aug_json_path(folder, **flags)

    return create_json_of_image_name_to_augmented_images_paths(
        cfg.dataset,
        augmented_image_folder_path=output_folder,
        init_log=False,
        weights_dir=cfg.weights_dir,
        device=None if pipe is None else pipe.device,
        **kw,
    )
