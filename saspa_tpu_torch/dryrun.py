"""The port's compile-check and multi-card dry-run entry points
(counterpart of the repo root's __graft_entry__.py):

entry()                -> (fn, args): one CFG denoise step of the full-width
                          SD1.5 UNet with the canny ControlNet's residuals,
                          seeded, in bf16 on the card (batch 2, 64^2
                          latents, 77 x 768 context, 512^2 control images).
dryrun_multichip(n)    -> the multi-card dry run over the initialised group
                          of n ranks: one full WSDAN-CAL train step on a
                          (n // 2, 2) mesh (n even, >= 4; else (n, 1)) with
                          the classifier head split over the model axis
                          (parallel/head.py) and the batch over the data
                          axis; the tiny SD1.5 + canny fused generation
                          over the same mesh's data axis; the filter's
                          batched_logits over a pure data-parallel mesh on
                          3n + 1 images (a padded last batch).

    torchrun --nproc_per_node=N -m saspa_tpu_torch.dryrun      # N cards, NCCL
    torchrun --nproc_per_node=4 -m saspa_tpu_torch.dryrun --device cuda:0 --backend gloo   # one card

runs entry() once (rank 0) and then dryrun_multichip(N).  Everything runs on
the card unless the caller passes a CPU device, as the tests do; a missing
card raises.  Imports nothing of JAX.

Where the port differs from the JAX dry run: its draws follow the port's
own seeded init (utils/rng.py, models/layers.py::init_weights), so the
numbers are not JAX's; stage 3's synthetic images are drawn once in path
order, so every rank scores the same pixels for a path (JAX's thread pool
draws them in its own order).
"""

from __future__ import annotations

import argparse
import copy
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from saspa_tpu_torch import default_dtype, resolve_device

# entry(): JAX's shapes (__graft_entry__.py:30-34)
ENTRY_BATCH = 2  # cond + uncond, CFG folded into the batch
ENTRY_LATENT_HW = 64  # 512^2 pixels / 8
ENTRY_CONTEXT = 77
ENTRY_CONTROL_HW = 512
CONTROLNET_SCALE = 0.75

# dryrun_multichip(): JAX's sizes (__graft_entry__.py:88-96, 147-160, 174)
NUM_CLASSES = 8
IMG = 64
M = 4
GEN_STEPS = 2
GUIDANCE = 7.5


def make_denoise_step(unet_cfg=None, dtype: Optional[torch.dtype] = None, device=None,
                      latent_hw: int = ENTRY_LATENT_HW, control_hw: int = ENTRY_CONTROL_HW):
    """(fn, (params, latents, t, ctx, cond_img)) for a UNet config (SD1.5's
    by default): fn(params, latents (B, h, w, 4) f32, t (B,) int, ctx (B, L,
    cross_attention_dim) f32, cond_img (B, H, W, 3) in [0, 1]) -> (B, h, w,
    4) f32, the ControlNet at scale 0.75 then the UNet with its residuals
    (__graft_entry__.py:41-50).  NHWC at this boundary, as JAX's arguments
    and the sampler's (diffusion/sampler.py): the models take the NCHW
    views, channels-last in memory, as the kernels want them.  params
    {"unet", "controlnet"}: seeded as a pipeline seeds them (the
    ControlNet's zero convs zero); the inputs are zeros, as JAX's.  dtype
    None: bf16 on the card, f32 on the CPU."""
    from saspa_tpu_torch.models.controlnet import ZERO_INIT_PREFIXES, ControlNet
    from saspa_tpu_torch.models.layers import init_weights
    from saspa_tpu_torch.models.unet import SD15_UNET, UNet2DCondition

    cfg = unet_cfg or SD15_UNET
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    unet = UNet2DCondition(cfg, dtype, device).eval()
    controlnet = ControlNet(cfg, dtype, device).eval()
    init_weights(unet, 0)
    init_weights(controlnet, 7, zero_prefixes=ZERO_INIT_PREFIXES)

    @torch.no_grad()
    def denoise_step(params, latents, t, ctx, cond_img):
        cn, lat = params["controlnet"], latents.permute(0, 3, 1, 2)
        down_res, mid_res = cn(lat, t, ctx, cn.embed_cond(cond_img.permute(0, 3, 1, 2)), CONTROLNET_SCALE)
        return params["unet"](lat, t, ctx, down_res, mid_res).permute(0, 2, 3, 1)

    args = ({"unet": unet, "controlnet": controlnet},
            torch.zeros(ENTRY_BATCH, latent_hw, latent_hw, cfg.in_channels, device=device),
            torch.zeros(ENTRY_BATCH, dtype=torch.int64, device=device),
            torch.zeros(ENTRY_BATCH, ENTRY_CONTEXT, cfg.cross_attention_dim, device=device),
            torch.zeros(ENTRY_BATCH, control_hw, control_hw, 3, device=device))
    return denoise_step, args


def entry(device=None):
    """One CFG denoise step of SD1.5 + canny ControlNet at full width:
    (fn, args) as JAX's entry() returns them, in bf16 on the card."""
    return make_denoise_step(device=device)


def _log(mesh, *what) -> None:
    if mesh.rank == 0:
        print(*what, flush=True)


def train_config(n: int):
    """Stage 1's TrainConfig: the planes preset at 64^2, ResNet-50, M 4,
    batch 2n, f32 (__graft_entry__.py:91-94)."""
    from saspa_tpu_torch.utils.config import get_train_config

    return get_train_config("planes").replace(image_size=(IMG, IMG), net="resnet50", batch_size=2 * n,
                                              num_attentions=M, compute_dtype="float32")


def train_stage(n: int, mesh, device) -> dict:
    """Stage 1: one WSDAN-CAL step (the planes preset at 64^2, ResNet-50,
    M 4, 8 classes, batch 2n, f32) on `mesh`, the head sharded over its
    model axis; returns the loss, the step and stage 3's model (the initial
    state, whole head)."""
    from saspa_tpu_torch.fgvc.train import create_train_state, make_train_step
    from saspa_tpu_torch.models.layers import sync_batch_norms
    from saspa_tpu_torch.parallel import replicated, shard_batch, shard_head

    cfg = train_config(n)
    state = create_train_state(cfg, NUM_CLASSES, device, init_seed=0)
    if mesh.size > 1:
        replicated(mesh, [state.model, state.feature_center, state.momentum])
    initial = copy.deepcopy(state.model).eval()  # replicate, then shard (parallel/head.py)
    sync_batch_norms(state.model, mesh)
    shard_head(state.model, mesh, state.momentum)
    step = make_train_step(cfg, 10, mesh)
    rng = np.random.RandomState(0)
    X = torch.from_numpy(rng.rand(cfg.batch_size, IMG, IMG, 3).astype(np.float32)).permute(0, 3, 1, 2).contiguous()
    y = torch.from_numpy(rng.randint(0, NUM_CLASSES, cfg.batch_size).astype(np.int64))
    X, y = (t.to(device) for t in shard_batch(mesh, (X, y)))
    metrics = step(state, X, y, np.array([0, 1], np.uint32))  # jax.random.PRNGKey(1)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"dryrun_multichip: non-finite loss {loss}")
    if state.step != 1:
        raise RuntimeError(f"dryrun_multichip: step {state.step} after one step")
    _log(mesh, f"dryrun_multichip OK (train): mesh={mesh.shape} loss={loss:.4f}")
    return {"loss": loss, "step": state.step, "mesh": mesh.shape, "model": initial}


def generation_pipeline(device):
    """The dry run's tiny SD1.5 + canny pipeline (__graft_entry__.py:147-160),
    f32, seeded."""
    from saspa_tpu_torch.diffusion.pipelines import DiffusionPipeline
    from saspa_tpu_torch.models.text_encoder import CLIPTextConfig
    from saspa_tpu_torch.models.unet import UNetConfig
    from saspa_tpu_torch.models.vae import VAEConfig

    return DiffusionPipeline(
        base_model="sd_v1.5", controlnet="canny", sampler="ddim", dtype=torch.float32, device=device,
        unet_cfg=UNetConfig(
            block_out_channels=(32, 64),
            down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
            layers_per_block=1, transformer_layers_per_block=(1, 1),
            num_attention_heads=(2, 2), cross_attention_dim=32,
        ),
        vae_cfg=VAEConfig(block_out_channels=(8, 16), layers_per_block=1),
        text_cfgs=(CLIPTextConfig(width=32, layers=2, heads=2),),
    )


def generation_stage(n: int, mesh, device, pipe=None) -> dict:
    """Stage 2: make_fused_generate(64, 64, 2 steps, CFG 7.5) on a batch of
    n, each data index generating its rows (its model ranks the same rows),
    the uint8 images gathered over the data axis."""
    from saspa_tpu_torch.parallel.mesh import gather_rows

    pipe = pipe or generation_pipeline(device)
    fused = pipe.make_fused_generate(IMG, IMG, num_inference_steps=GEN_STEPS, guidance_scale=GUIDANCE)
    ids = pipe.tokenizer(["a photo of a plane"] * n)
    neg_ids = pipe.tokenizer([""] * n)
    src = np.tile(np.linspace(0, 255, IMG, dtype=np.float32)[None, :, None, None], (n, 1, IMG, 3))
    lf = pipe.latent_factor
    latents = np.random.RandomState(1).randn(n, IMG // lf, IMG // lf, 4).astype(np.float32)
    rows = mesh.rows(n)
    imgs = gather_rows(mesh, fused(pipe.params, ids[rows], neg_ids[rows], src[rows], latents[rows]))
    if tuple(imgs.shape) != (n, IMG, IMG, 3) or imgs.dtype != torch.uint8:
        raise RuntimeError(f"dryrun_multichip: images {tuple(imgs.shape)} {imgs.dtype}")
    _log(mesh, f"dryrun_multichip OK (generation): mesh={mesh.shape} batch={n} -> uint8 {tuple(imgs.shape)}")
    return {"images": imgs.cpu(), "rows": rows.stop - rows.start}


def filter_stage(n: int, mesh, model) -> dict:
    """Stage 3: batched_logits of `model` (stage 1's initial state) over 3n
    + 1 synthetic 64^2 images at batch 2n on `mesh`, and the keep
    predicates of the confidence and semantic filters on its logits."""
    from saspa_tpu_torch.filters.batches import new_timings
    from saspa_tpu_torch.filters.clip_filters import semantic_keep
    from saspa_tpu_torch.filters.confidence import batched_logits

    n_imgs = 3 * n + 1  # deliberately uneven: a padded last batch
    paths = [f"synthetic_{i}.png" for i in range(n_imgs)]
    pixels = np.random.RandomState(2).rand(n_imgs, IMG, IMG, 3).astype(np.float32)
    index = {p: i for i, p in enumerate(paths)}
    timings = new_timings()
    logits = batched_logits(model, paths, lambda path: pixels[index[path]], batch_size=2 * n, timings=timings,
                            mesh=mesh)
    if logits.shape != (n_imgs, NUM_CLASSES) or not np.isfinite(logits).all():
        raise RuntimeError(f"dryrun_multichip: logits {logits.shape}, finite {np.isfinite(logits).all()}")
    topk = np.argsort(-logits, axis=-1)[:, :3]  # the predicates take host logits: top-k membership
    keep_conf = (topk == 0).any(axis=-1)
    keep_sem = semantic_keep(np.concatenate([logits[:, :1], logits[:, 1:7]], axis=-1))
    _log(mesh, f"dryrun_multichip OK (filter): mesh={mesh.shape} scored={logits.shape} "
               f"keep_conf={int(keep_conf.sum())} keep_sem={int(keep_sem.sum())}")
    return {"logits": logits, "scored": timings["images"], "keep_conf": keep_conf, "keep_sem": keep_sem}


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The three stages over the initialised group of n_devices ranks (the
    module docstring); prints JAX's three "dryrun_multichip OK" lines (rank
    0) and returns each stage's results on this rank."""
    from saspa_tpu_torch.parallel.mesh import make_mesh

    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if n_devices != world:
        raise ValueError(f"dryrun_multichip({n_devices}) in a group of {world} ranks")
    model_par = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = make_mesh((n_devices // model_par, model_par))
    device = resolve_device(device if device is not None else mesh.device)
    train = train_stage(n_devices, mesh, device)
    generation = generation_stage(n_devices, mesh, device)
    filt = filter_stage(n_devices, make_mesh(), train.pop("model"))  # pure dp for the filter sweep
    return {"train": train, "generation": generation, "filter": filt}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="entry() once, then dryrun_multichip over torchrun's ranks")
    ap.add_argument("--device", help="this rank's device (default: the card of LOCAL_RANK; 'cuda:0' puts every "
                                     "rank on one card, under --backend gloo; 'cpu' runs on the CPU)")
    ap.add_argument("--backend", help="nccl or gloo (default: nccl on a card, gloo on the CPU)")
    ap.add_argument("--skip_entry", action="store_true", help="run only dryrun_multichip")
    args = ap.parse_args(argv)
    from saspa_tpu_torch.parallel.mesh import init_distributed, make_mesh

    world = init_distributed(args.backend, args.device)
    device = resolve_device(args.device or make_mesh().device)
    rank = dist.get_rank() if world > 1 else 0
    if not args.skip_entry and rank == 0:
        fn, fargs = entry(device)
        out = fn(*fargs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        print("entry OK:", tuple(out.shape), out.dtype, flush=True)
    if world > 1:
        dist.barrier()
    dryrun_multichip(world, device)
    if world > 1:
        dist.barrier()
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
