#!/usr/bin/env python3
"""What bounds K2 (LayerNorm + GEGLU feed-forward, saspa_tpu_torch/csrc/ln_geglu.cu)
on one NVIDIA H100.

    python3 k2_probe.py [--shape M C] [--parent DIR] [--iters N]

Builds variants of the kernel, each with one part swapped for a cheaper
stand-in, into a temporary directory (nvcc, one process per variant, all
started together), and times each stage (the row-normalize, the first product
with its GEGLU epilogue, the second product with its residual epilogue) by
its device time under torch.profiler, on the same seeded bf16 inputs
(default: rows 65536, C320, SD1.5's level 0 at 512^2):
  as_is    the kernel as it is (held against fused_ln_geglu_plain within 1%
           of the largest output, as chip_smoke.py holds it);
  no_gelu  gelu(g) = g: the GEGLU epilogue without the erf polynomial and
           its division;
  no_b     neither product loads its B operand (the weights) into shared
           memory: the products read stale tiles, and the L2-to-shared
           traffic of the two products drops by half and by 55%;
  one_cta  one persistent block an SM (4-stage rings, no second block to
           overlap its epilogue with);
  one_tile a block for every tile, not persistent (each block fills its
           ring anew and nothing loads during its epilogue).
Only as_is computes the function; the other outputs are not read.  With
--parent DIR, the K2 of another checkout (DIR/saspa_tpu_torch/csrc: this
entry point, or the earlier two-launch mma.sync kernel's) is timed beside
them.
Each line also gives the bytes that each product's blocks move from L2 into
shared memory (from the tile geometry) and the rate that implies.  Prints one
JSON line per variant, then the card's name and power limit.  Needs one CUDA
card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# (variant, file, text, replacement, count): each text must occur count times in the source
VARIANTS = {
    "as_is": [],
    "no_gelu": [("ln_geglu.cu", "return 0.5f * x * (1.0f + erf_poly(x * 0.70710678118654752f));", "return x;", 1)],
    "no_b": [("gemm_wgmma.cuh", "mbar_arrive_expect_tx(full(st), Cf::STAGE_BYTES);",
              "mbar_arrive_expect_tx(full(st), GG_A_BYTES);", 1),
             ("ln_geglu.cu", "tma_load_2d(b, &mw1, j * 64, n * 64, bar);", "", 1),
             ("ln_geglu.cu", "tma_load_2d(b + 64 * 128, &mw1, j * 64, F + n * 64, bar);", "", 1),
             ("ln_geglu.cu", "tma_load_2d(b, &mw2, j * 64, n * BN, bar);", "", 1)],
    "one_cta": [("gemm_wgmma.cuh", "constexpr int GG_STAGES = 3;", "constexpr int GG_STAGES = 4;", 1),
                ("gemm_wgmma.cuh", '    static_assert(2 * (SMEM + 1024 + 64) <= 233472, "two blocks an SM");\n', "", 1),
                ("ln_geglu.cu", "__launch_bounds__(GG_THREADS, 2)", "__launch_bounds__(GG_THREADS, 1)", 2),
                ("gemm_wgmma.cuh", "return ntiles < 2 * sms ? ntiles : 2 * sms;", "return ntiles < sms ? ntiles : sms;",
                 1)],
    "one_tile": [("gemm_wgmma.cuh", "return ntiles < 2 * sms ? ntiles : 2 * sms;", "return ntiles;", 1)],
}
STAGES = {"norm": ("ln_geglu_norm_kernel",), "up": ("ln_geglu_up_kernel", "ln_geglu_hidden_kernel"),
          "down": ("ln_geglu_down_kernel", "geglu_out_kernel")}


def build(name: str, csrc: Path, edits, out_dir: Path):
    """Starts nvcc on a copy of csrc with the edits applied; returns (lib path, process)."""
    from saspa_tpu_torch.ops import _build

    src = out_dir / f"src_{name}"
    shutil.copytree(csrc, src)
    for fname, text, repl, count in edits:
        p = src / fname
        body = p.read_text()
        if body.count(text) != count:
            raise SystemExit(f"k2_probe: variant {name}: {body.count(text)} of {count} in {fname}: {text!r}")
        p.write_text(body.replace(text, repl))
    lib = out_dir / f"lib{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src / "ln_geglu.cu")]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def l2_bytes(m: int, c: int, bn_down: int) -> dict:
    """Bytes each product's blocks load from L2 into shared memory: every
    128-row block of the first product reads its xn rows and 128 W1 rows
    (64 value, 64 gate) over all of C, and every 128 x bn_down block of the
    second its hid rows and bn_down W2 rows over all of F."""
    f, mb = 4 * c, -(-m // 128)
    return {"up": mb * (f // 64) * (128 + 128) * c * 2, "down": mb * (c // bn_down) * (128 + bn_down) * f * 2}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", type=int, nargs=2, default=[65536, 320], metavar=("M", "C"))
    ap.add_argument("--parent", type=Path, help="a checkout whose K2 is timed beside these variants")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k2_probe: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import device_ms, k2_ptxas, nvidia_smi_line
    from saspa_tpu_torch.ops import _build
    from saspa_tpu_torch.ops import geglu

    m, c = args.shape
    f = 4 * c
    tmp = Path(tempfile.mkdtemp(prefix="k2_probe_"))
    try:
        jobs = {n: build(n, ROOT / "saspa_tpu_torch/csrc", e, tmp) for n, e in VARIANTS.items()}
        old_api = False  # the earlier entry point: no xn scratch, no plan
        if args.parent:
            jobs["parent"] = build("parent", args.parent / "saspa_tpu_torch/csrc", [], tmp)
            old_api = "int lanes" not in (args.parent / "saspa_tpu_torch/csrc/ln_geglu.cu").read_text()
        fns = {}
        for n, (lib, proc) in jobs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise SystemExit(f"k2_probe: nvcc failed for {n}:\n{err}")
            if n != "parent":  # registers and spills of the wgmma kernels
                print(json.dumps({"variant": n, "ptxas": k2_ptxas(err) if n == "as_is" else
                                  {k: v.get("registers") for k, v in _ptxas(err).items()}}), flush=True)
            fn = getattr(ctypes.CDLL(str(lib)), "saspa_ln_geglu")
            fn.restype = ctypes.c_int
            if n == "parent" and old_api:
                P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
                fn.argtypes = [P] * 9 + [I] * 3 + [F, P]
            else:
                fn.argtypes = _build.SIGNATURES["ln_geglu"][1]
            fns[n] = fn

        gen = torch.Generator(device="cuda").manual_seed(0)
        bf = torch.bfloat16

        def rn(*shape, std=1.0):
            return torch.randn(shape, generator=gen, device="cuda") * std

        x = rn(m, c).to(bf)
        lns, lnb = 1.0 + rn(c, std=0.1), rn(c, std=0.1)
        w1, b1 = rn(2 * f, c, std=c ** -0.5).to(bf), rn(2 * f, std=0.1).to(bf)
        w2, b2 = rn(c, f, std=f ** -0.5).to(bf), rn(c, std=0.1).to(bf)
        ref = geglu.fused_ln_geglu_plain(x, lns, lnb, w1, b1, w2, b2)
        xn, hid, out = (torch.empty(m, n, dtype=bf, device="cuda") for n in (c, f, c))
        plan = geglu.geglu_plan(m, c, torch.cuda.get_device_properties(0).multi_processor_count)
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [t.data_ptr() for t in (x, lns, lnb, w1, b1, w2, b2)]
        nbytes = l2_bytes(m, c, plan.bn_down)
        for n, fn in fns.items():
            if n == "parent" and old_api:
                call_args = (*ptrs, hid.data_ptr(), out.data_ptr(), m, c, f, 1e-5, stream)
            else:
                call_args = (*ptrs, xn.data_ptr(), hid.data_ptr(), out.data_ptr(), m, c, f, *plan.ln, plan.bn_down,
                             1e-5, stream)

            def call():
                err = fn(*call_args)
                if err:
                    raise SystemExit(f"k2_probe: {n}: CUDA error {err}")

            call()
            torch.cuda.synchronize()
            row = {"variant": n, "M": m, "C": c}
            if n in ("as_is", "parent"):
                row["max_abs_err"] = (out.float() - ref.float()).abs().max().item()
                row["ref_max"] = ref.float().abs().max().item()
                if row["max_abs_err"] > 1e-2 * row["ref_max"]:
                    raise SystemExit(f"k2_probe: {n} disagrees with the plain version: {row}")
            total, by = device_ms(call, args.iters)
            row["device_ms"] = total
            row["stage_device_ms"] = {s: sum(v for k, v in by.items() if any(p in k for p in pats))
                                      for s, pats in STAGES.items()}
            if n not in ("parent", "no_b"):  # no_b moves less than the geometry says
                row["l2_to_smem_bytes"] = nbytes
                row["l2_to_smem_tb_per_s"] = {s: nbytes[s] / (row["stage_device_ms"][s] * 1e-3) / 1e12
                                              for s in nbytes if row["stage_device_ms"][s] > 0}
            print(json.dumps(row), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(nvidia_smi_line())
    return 0


def _ptxas(log: str) -> dict:
    from chip_smoke import ptxas_report

    return {k: v for k, v in ptxas_report(log).items() if "_up_" in k or "_down_" in k}


if __name__ == "__main__":
    sys.exit(main())
