#!/usr/bin/env python3
"""What bounds K6 (streamed flash attention, saspa_tpu_torch/csrc/flash_attention.cu)
on one NVIDIA H100.

    python3 k6_probe.py [--shape B L H D] [--parent DIR] [--iters N]

Builds variants of the kernel, each with one part of its tile loop swapped
for a cheaper stand-in, into a temporary directory (nvcc, one process per
variant, all started together), and times each with CUDA events on the same
seeded bf16 inputs (default: B16 L16384 H8 d40, SD1.5's level 0 at 1024^2):
  as_is    the kernel as it is (held against flash_attention_plain within 1%
           of the largest output, as chip_smoke.py holds it);
  no_exp   exp2 as one FFMA on the FMA pipe instead of MUFU.EX2;
  no_pack  bf16(P) by truncation (one byte permute a pair) instead of cvt;
  no_pv    no P.V wgmma (P is still computed and kept alive);
  no_turns the warpgroups issue their Q.K^T when ready instead of in turns.
Only as_is computes the function; the other outputs are not read.  A variant
that saves time shows what its part costs.  With --parent DIR, the K6 of
another checkout (DIR/saspa_tpu_torch/csrc) is built and timed beside them.
Prints one JSON line per variant, then the exp2 floor at the card's maximum
SM clock, and the card's name and power limit.  Needs one CUDA card.
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

# (variant, file, text, replacement): each text must occur in the source
VARIANTS = {
    "as_is": [],
    "no_exp": [("attention_wgmma.cuh", 'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));',
                "y = fmaf(x, 0.5f, 1.0f);")],
    "no_pack": [("mma_bf16.cuh", "__nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);\n"
                 "    return *reinterpret_cast<uint32_t*>(&v);",
                 "return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);")],
    "no_pv": [("flash_attention.cu", "issue_pv<C::NO, BN>(oacc, pa, sV + st * C::TILE_BYTES);", "")],
    "no_turns": [("flash_attention.cu", "static constexpr bool RING = WGS > 1;", "static constexpr bool RING = false;")],
}


def build(name: str, csrc: Path, edits, out_dir: Path):
    """Starts nvcc on a copy of csrc with the edits applied; returns (lib path, process)."""
    from saspa_tpu_torch.ops import _build

    src = out_dir / f"src_{name}"
    shutil.copytree(csrc, src)
    for fname, text, repl in edits:
        p = src / fname
        body = p.read_text()
        if text not in body:
            raise SystemExit(f"k6_probe: variant {name}: text not found in {fname}: {text!r}")
        p.write_text(body.replace(text, repl))
    lib = out_dir / f"lib{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src / "flash_attention.cu")]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def load(lib: Path):
    from saspa_tpu_torch.ops import _build

    fn_name, argtypes = _build.SIGNATURES["flash_attention"]
    fn = getattr(ctypes.CDLL(str(lib)), fn_name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", type=int, nargs=4, default=[16, 16384, 8, 40], metavar=("B", "L", "H", "D"))
    ap.add_argument("--parent", type=Path, help="a checkout whose K6 is timed beside these variants")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k6_probe: no CUDA device", file=sys.stderr)
        return 2
    from saspa_tpu_torch.ops import attention as att

    b, l, h, d = args.shape
    dp = att.pad_head_dim(d)
    tmp = Path(tempfile.mkdtemp(prefix="k6_probe_"))
    try:
        jobs = {n: build(n, ROOT / "saspa_tpu_torch/csrc", e, tmp) for n, e in VARIANTS.items()}
        if args.parent:
            jobs["parent"] = build("parent", args.parent / "saspa_tpu_torch/csrc", [], tmp)
        fns = {}
        for n, (lib, proc) in jobs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise SystemExit(f"k6_probe: nvcc failed for {n}:\n{err}")
            if n == "as_is":  # registers and spills of each instantiation, and those whose wgmmas ptxas serialised
                from chip_smoke import k6_ptxas
                print(json.dumps({"ptxas": k6_ptxas(err)}), flush=True)
            fns[n] = load(lib)
        gen = torch.Generator(device="cuda").manual_seed(0)
        q = (3.0 * torch.randn(b, l, h, d, generator=gen, device="cuda")).to(torch.bfloat16)
        k, v = (torch.randn(b, l, h, d, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(2))
        scale_q = float(torch.tensor(d ** -0.5, dtype=torch.bfloat16))
        stream = torch.cuda.current_stream().cuda_stream
        ref = att.flash_attention_plain(q, k, v, d ** -0.5)
        for n, fn in fns.items():
            out = torch.empty_like(q)

            def call():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, l, l, h, d, dp, scale_q, stream)
                if err:
                    raise SystemExit(f"k6_probe: {n}: CUDA error {err}")

            call()
            torch.cuda.synchronize()
            row = {"variant": n, "B": b, "L": l, "H": h, "d": d}
            if n in ("as_is", "parent"):
                row["max_abs_err"] = (out.float() - ref.float()).abs().max().item()
                row["ref_max"] = ref.float().abs().max().item()
                if row["max_abs_err"] > 1e-2 * row["ref_max"]:
                    raise SystemExit(f"k6_probe: {n} disagrees with the plain version: {row}")
            for _ in range(2):
                call()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.iters):
                call()
            end.record()
            torch.cuda.synchronize()
            row["ms"] = start.elapsed_time(end) / args.iters
            print(json.dumps(row), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True, check=True).stdout
    name, power, clock = (x.strip() for x in smi.strip().splitlines()[0].split(","))
    exps = float(b) * h * l * l
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(json.dumps({"exp2_floor_ms": exps / (sms * 16 * float(clock) * 1e6) * 1e3, "scores": exps, "sms": sms,
                      "clocks_max_sm_mhz": float(clock)}))
    print(f"{name}, {power} W")
    return 0


if __name__ == "__main__":
    sys.exit(main())
