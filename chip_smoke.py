#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--steps N] [--seed S] [--profile OUT.json]

Phases, each printing one JSON line:
  1. build   -- builds every CUDA kernel of the port from saspa_tpu_torch/csrc
                (one nvcc per source, in parallel);
  2. kernels -- each kernel against its plain PyTorch version on the card at
                every main-path shape, from the same seeded bf16 inputs, with
                kernel / plain / library times from CUDA events;
  3. main    -- the port's main path: DiffusionPipeline(sd_v1.5, canny, ddim,
                bf16) at full SD1.5 width with seeded weights, batch 8 at
                512^2, through make_fused_generate; launch counters prove that
                every eligible site ran the kernels;
  4. reference -- the same pipeline's output against a CPU f32 run of the
                plain path on a small input, and the card's Canny against the
                CPU's, bit for bit.
With --profile, one more main-path run under torch.profiler writes the device
time by kernel to OUT.json and prints a summary line.
Then the kernels line, the card's name and power limit (nvidia-smi) and, as
the last line, {"ok": true, "device": {...}}.  Any failure exits non-zero
before the last line.  Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM at 700 W
H100_HBM_BYTES = 3.35e12  # HBM3 bytes/s

# K1 shapes on the main path at 512^2: (what, B, L, H, d, d_pad)
K1_SHAPES = [
    ("unet/cn level 0, before the CFG fork", 8, 4096, 8, 40, 64),
    ("unet/cn level 0", 16, 4096, 8, 40, 64),
    ("unet/cn level 1", 16, 1024, 8, 80, 128),
    ("unet/cn level 2", 16, 256, 8, 160, 192),
    ("vae mid attention", 8, 4096, 1, 512, 512),
]
# K2 shapes: (what, B, L, C); F = 4C
K2_SHAPES = [
    ("level 0", 16, 4096, 320),
    ("level 1", 16, 1024, 640),
    ("level 2", 16, 256, 1280),
    ("mid", 16, 64, 1280),
]


class SmokeFailure(RuntimeError):
    pass


def require(ok, *what) -> None:
    """A check that holds under python -O too."""
    if not ok:
        raise SmokeFailure(" ".join(str(w) for w in what))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / H100_BF16_FLOPS * 1e3, nbytes / H100_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def check_k1(gen):
    from saspa_tpu_torch.ops import attention as att

    rows = []
    for what, b, l, h, d, dp in K1_SHAPES:
        def padded(x):
            return torch.nn.functional.pad(x, (0, dp - d)).reshape(b, l, h * dp)

        shape = (b, l, h, d)
        scale = (1.0 / math.sqrt(d)) * att.LOG2E
        q = padded(torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16).contiguous()
        k = padded(torch.randn(shape, generator=gen, device="cuda")).to(torch.bfloat16).contiguous()
        v = padded(torch.randn(shape, generator=gen, device="cuda")).to(torch.bfloat16).contiguous()
        out = att.flash_attention_packed(q, k, v, h)
        ref = att.flash_attention_packed_plain(q, k, v, h)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ref_max = ref.float().abs().max().item()
        # bf16 output (relative rounding 2^-9) and bf16 P in the P.V product:
        # the kernel's streamed online softmax sums in another order than the
        # plain one-pass softmax, so allow 1% of the largest output
        require(err <= 1e-2 * ref_max, what, "max |kernel - plain|", err, "> 1% of", ref_max)
        pad_zero = bool((out.reshape(b, l, h, dp)[..., d:] == 0).all().item()) if dp > d else True
        require(pad_zero, what, "padded output columns are not exactly zero")
        qh, kh, vh = (x.reshape(b, l, h, dp).transpose(1, 2) for x in (q, k, v))
        ms = cuda_ms(lambda: att.flash_attention_packed(q, k, v, h), 10)
        plain_ms = cuda_ms(lambda: att.flash_attention_packed_plain(q, k, v, h), 3, warmup=1)
        lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, scale=math.log(2.0)), 10)
        b_ms, b_by = bound(4.0 * b * h * l * l * dp, 4 * b * l * h * dp * 2)
        rows.append(dict(shape=what, B=b, L=l, H=h, d=d, d_pad=dp, max_abs_err=err, ref_max=ref_max,
                         pad_cols_zero=pad_zero, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by))
        del q, k, v, out, ref
    return rows


def check_k2(gen):
    from saspa_tpu_torch.ops import geglu

    rows = []
    bf = torch.bfloat16
    for what, b, l, c in K2_SHAPES:
        f = 4 * c

        def rn(*shape, std=1.0):
            return torch.randn(shape, generator=gen, device="cuda") * std

        x = rn(b, l, c).to(bf)
        lns, lnb = 1.0 + rn(c, std=0.1), rn(c, std=0.1)
        w1, b1 = rn(2 * f, c, std=c ** -0.5).to(bf), rn(2 * f, std=0.1).to(bf)
        w2, b2 = rn(c, f, std=f ** -0.5).to(bf), rn(c, std=0.1).to(bf)
        args = (x, lns, lnb, w1, b1, w2, b2)
        out = geglu.fused_ln_geglu(*args)
        ref = geglu.fused_ln_geglu_plain(*args)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ref_max = ref.float().abs().max().item()
        # the kernel reproduces every bf16 rounding point of the plain version;
        # only f32 summation order differs, which can flip the bf16 rounding of
        # hid and of the output's three bf16 steps: allow 1% of the largest output
        require(err <= 1e-2 * ref_max, what, "max |kernel - plain|", err, "> 1% of", ref_max)
        ms = cuda_ms(lambda: geglu.fused_ln_geglu(*args), 10)
        plain_ms = cuda_ms(lambda: geglu.fused_ln_geglu_plain(*args), 3, warmup=1)
        m = b * l
        b_ms, b_by = bound(6.0 * m * c * f, 2 * (2 * m * c + 3 * c * f + 2 * f + c) + 8 * c)
        rows.append(dict(shape=what, rows=m, C=c, F=f, max_abs_err=err, ref_max=ref_max, ms=ms,
                         plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by))
        del args, x, out, ref
    return rows


def profile_main(run, out_path: str, steps: int) -> None:
    """Device time by kernel over one main-path run (torch.profiler/CUPTI)."""
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = run()
    rows = []
    for e in prof.key_averages():  # kernels only: aten ops would count their kernels twice
        dev_us = getattr(e, "self_device_time_total", 0) or 0
        if str(e.device_type).endswith("CUDA") and dev_us > 0:
            rows.append({"name": e.key, "calls": e.count, "device_ms": dev_us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows) / 1e3

    def group(name: str) -> str:
        if "attention_packed_kernel" in name:
            return "attention_packed (K1)"
        if "ln_geglu_hidden_kernel" in name or "geglu_out_kernel" in name:
            return "ln_geglu (K2)"
        n = name.lower()
        if any(k in n for k in ("conv", "fprop", "cudnn", "implicit")):
            return "convolution (cuDNN)"
        if any(k in n for k in ("gemm", "nvjet", "cublas", "cutlass")):
            return "matmul (cuBLAS)"
        if "reduce" in n:
            return "reductions (norm statistics, softmax)"
        return "elementwise and copies"

    groups: dict = {}
    for r in rows:
        g = group(r["name"])
        groups[g] = groups.get(g, 0.0) + r["device_ms"]
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    Path(out_path).write_text(json.dumps({"steps": steps, "wall_s": wall, "device_busy_s": busy,
                                          "groups_ms": groups, "kernels": rows}, indent=1))
    emit({"phase": "profile", "steps": steps, "wall_s": wall, "device_busy_s": busy,
          "idle_share": 1.0 - busy / wall, "groups_ms": groups, "top": rows[:12], "table": out_path})


def synthetic_sources(rng: np.random.RandomState, n: int, size: int) -> np.ndarray:
    """Smooth synthetic scenes: a colour gradient with a few filled ellipses."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    imgs = np.empty((n, size, size, 3), np.float32)
    for i in range(n):
        a, c = rng.uniform(40, 200, 3), rng.uniform(-60, 60, 3)
        img = a[None, None] + c[None, None] * (0.6 * xx + 0.4 * yy)[..., None]
        for _ in range(rng.randint(3, 7)):
            cy, cx, ry, rx = rng.uniform(0.15, 0.85, 2).tolist() + rng.uniform(0.05, 0.3, 2).tolist()
            inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
            img[inside] = rng.uniform(0, 255, 3)
        imgs[i] = img
    return np.clip(np.round(imgs), 0, 255).astype(np.uint8)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4, help="DDIM steps of the main path (the recipe uses 30)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", metavar="OUT.json", help="also profile one main-path run, write the table here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on the card", file=sys.stderr)
        return 2
    if args.steps < 2:
        ap.error("--steps must be at least 2")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from saspa_tpu_torch.diffusion.pipelines import DiffusionPipeline
    from saspa_tpu_torch.gen.tokenizer import NEGATIVE_PROMPT
    from saspa_tpu_torch.models.controlnet import ZERO_INIT_PREFIXES
    from saspa_tpu_torch.ops import _build, attention, geglu
    from saspa_tpu_torch.ops.canny import canny_batch

    smi = nvidia_smi_line()
    build_s = _build.build_all()
    ptxas = {k: [ln.strip() for ln in v.splitlines() if "registers" in ln or "spill" in ln]
             for k, v in _build.build_log.items()}
    emit({"phase": "build", "seconds": build_s, "nvidia_smi": smi, "ptxas": ptxas})

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    k1 = check_k1(gen)
    emit({"phase": "kernels", "kernel": "attention_packed", "shapes": k1})
    k2 = check_k2(gen)
    emit({"phase": "kernels", "kernel": "ln_geglu", "shapes": k2})

    # ---- main path ---------------------------------------------------------
    t0 = time.perf_counter()
    pipe = DiffusionPipeline("sd_v1.5", controlnet="canny", sampler="ddim", dtype=torch.bfloat16, init_seed=args.seed)
    with torch.no_grad():  # small seeded values so the ControlNet residuals are not all zero
        zgen = torch.Generator(device="cuda").manual_seed(args.seed + 11)
        for name, p in sorted(pipe.params["controlnet"].named_parameters()):
            if name.startswith(ZERO_INIT_PREFIXES):
                p.copy_(torch.randn(p.shape, generator=zgen, device="cuda") * 0.02)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.RandomState(args.seed)
    b, size = 8, 512
    src = synthetic_sources(rng, b, size)
    prompts = [f"a photo of a {c} airliner on the runway" for c in ("red", "white", "blue", "grey") * 2]
    ids = pipe.tokenizer(prompts, pad="eot")
    neg_ids = pipe.tokenizer([NEGATIVE_PROMPT] * b, pad="eot")
    latents = rng.randn(b, size // 8, size // 8, 4).astype(np.float32)

    def run(steps):
        fn = pipe.make_fused_generate(size, size, steps, 7.5, 0.75, 120.0, 200.0)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(pipe.params, ids, neg_ids, src, latents, return_images=True)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    run(1)  # warm-up: cuDNN/cuBLAS heuristics, kernel library loads
    _, t1 = run(1)
    torch.cuda.reset_peak_memory_stats()
    attention.launches = geglu.launches = 0
    (u8, images), ts = run(args.steps)
    counts = {"attention_packed": attention.launches, "ln_geglu": geglu.launches}
    peak = torch.cuda.max_memory_allocated()
    require(u8.shape == (b, size, size, 3) and u8.dtype == torch.uint8, "output", tuple(u8.shape), u8.dtype)
    require(bool(torch.isfinite(images).all()), "non-finite images before quantisation")
    # per step: UNet 15 + ControlNet 6 self-attentions over >= 256 tokens, plus
    # the VAE's one; 16 + 7 transformer blocks
    want = {"attention_packed": 21 * args.steps + 1, "ln_geglu": 23 * args.steps}
    require(counts == want, "launch counts", counts, "expected", want)
    s_step = (ts - t1) / (args.steps - 1)
    emit({"phase": "main", "batch": b, "resolution": size, "steps": args.steps, "init_s": init_s,
          "wall_s": ts, "wall_1step_s": t1, "s_per_step": s_step, "img_per_s": b / ts,
          "img_per_s_30_steps_est": b / (t1 + 29 * s_step), "peak_mem_bytes": peak, "launches": counts,
          "launches_expected": want, "uint8_mean": u8.float().mean().item()})

    if args.profile:
        profile_main(lambda: run(args.steps), args.profile, args.steps)

    # ---- reference: small input against the plain path on the CPU ----------
    cpu = DiffusionPipeline("sd_v1.5", controlnet="canny", sampler="ddim", dtype=torch.float32, device="cpu",
                            init_seed=None)
    for k, mod in pipe.params.items():
        mods = mod if isinstance(mod, list) else [mod]
        cmods = cpu.params[k] if isinstance(mod, list) else [cpu.params[k]]
        for m, cm in zip(mods, cmods):
            cm.load_state_dict({n: t.float().cpu() for n, t in m.state_dict().items()})
    rs, n_small = 256, 1  # 32^2 latents: K1 at 1024 and 256 tokens, K2 on a ragged 32-row mid block
    small = (src[:n_small, ::2, ::2], ids[:n_small], neg_ids[:n_small], latents[:n_small, ::2, ::2])
    attention.launches = geglu.launches = 0
    _, img_gpu = pipe.make_fused_generate(rs, rs, 2, 7.5)(pipe.params, small[1], small[2], small[0], small[3],
                                                           return_images=True)
    small_counts = {"attention_packed": attention.launches, "ln_geglu": geglu.launches}
    _, img_cpu = cpu.make_fused_generate(rs, rs, 2, 7.5)(cpu.params, small[1], small[2], small[0], small[3],
                                                         return_images=True)
    diff = (img_gpu.float().cpu() - img_cpu).abs()
    # bf16 network with the kernels vs the f32 plain path: agreement to a few
    # uint8 levels on average (mean |diff| <= 0.02 of the [0, 1] range)
    mean_diff, max_diff = diff.mean().item(), diff.max().item()
    edges_gpu = canny_batch(torch.as_tensor(src, device="cuda"), 120.0, 200.0).cpu()
    edges_cpu = canny_batch(torch.as_tensor(src), 120.0, 200.0)
    canny_equal = bool(torch.equal(edges_gpu, edges_cpu))
    emit({"phase": "reference", "resolution": rs, "batch": n_small, "steps": 2, "launches": small_counts,
          "mean_abs_diff": mean_diff, "max_abs_diff": max_diff, "canny_bit_exact": canny_equal,
          "edge_fraction": (edges_gpu > 0).float().mean().item()})
    require(min(small_counts.values()) > 0, "reference run missed a kernel", small_counts)
    require(mean_diff <= 0.02, "card vs CPU mean |diff|", mean_diff)
    require(canny_equal, "Canny on the card differs from the CPU")

    kernels = [
        {"name": "attention_packed", "route": "cuda", "source": "saspa_tpu_torch/csrc/attention_packed.cu",
         "replaces": "saspa_tpu/ops/attention.py:181", "launches": counts["attention_packed"],
         "max_abs_err": max(r["max_abs_err"] for r in k1), **{k: k1[1][k] for k in
         ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")}},
        {"name": "ln_geglu", "route": "cuda", "source": "saspa_tpu_torch/csrc/ln_geglu.cu",
         "replaces": "saspa_tpu/ops/geglu.py:123", "launches": counts["ln_geglu"],
         "max_abs_err": max(r["max_abs_err"] for r in k2), **{k: k2[0][k] for k in
         ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")}},
    ]
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
