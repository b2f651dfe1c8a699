#!/usr/bin/env python3
"""What bounds the f32 attention core (saspa_tpu_torch/csrc/attention_f32.cu:
K1 f32 at d_pad 64/128/192, K6 f32, K5 f32's attention) on one NVIDIA H100.

    python3 f32_core_probe.py [--shape B L H D] [--parent DIR] [--iters N]

Builds variants of the core, each with one part of its tile loop taken out or
made cheaper, into a temporary directory (nvcc, one process per variant, all
started together), and times K1 f32's entry in each with CUDA events, in
turns, on the same seeded head-padded f32 inputs told the real head dim
(default: B16 L4096 H8 d40, SD1.5's level 0 at 512^2 in f32):
  as_is      the core as it is (held against flash_attention_packed_plain
             within 1e-4 of the largest output, as chip_smoke.py holds it);
  no_q_loads q read from shared memory once a K/V tile, not once a 4-dim step
             (4 of the score loop's 12 16-byte loads a step gone);
  no_v_loads V read once a key quad, not once a key (3 of 4 V loads gone);
  no_exp     the softmax without its exps (p = s - max);
  no_barrier no block barrier in the tile loop;
  no_copies  no K/V copies after the first tile.
Only as_is computes the function; the other outputs are not read.  A variant
that saves time shows what its part costs.  With --parent DIR, the core of
another checkout (DIR/saspa_tpu_torch/csrc, called with that checkout's C
signature) is built and timed beside them.  Prints one JSON line per variant,
then the card's name and power limit.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import math
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SRC = "attention_f32.cu"

# variant -> [(text, replacement)]: each text must occur in the source
VARIANTS = {
    "as_is": [],
    "no_q_loads": [("""        for (int c = 0; c < D; c += 4) {
            float4 qv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) qv[i] = af_ld4(sQw + (rg + RG * i) * SD + c);""",
                    """        float4 qv[4];
        for (int c = 0; c < D; c += 4) {
            if (c == 0) {
#pragma unroll
                for (int i = 0; i < 4; ++i) qv[i] = af_ld4(sQw + (rg + RG * i) * SD + c);
            }""")],
    "no_v_loads": [("""            float4 p[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) p[i] = af_ld4(sPw""", """            float4 p[4], vq[NCH];
#pragma unroll
            for (int i = 0; i < 4; ++i) p[i] = af_ld4(sPw"""),
                   ("""                    const float4 vv = af_ld4(sV + key * SV + 4 * CG * jj);""",
                    """                    if (cc == 0) vq[jj] = af_ld4(sV + key * SV + 4 * CG * jj);
                    const float4 vv = vq[jj];""")],
    "no_exp": [("                const float p = af_exp<EXP2>(s[i][e] - mn);", "                const float p = s[i][e] - mn;")],
    "no_barrier": [("""            cp_async_wait<1>();
        __syncthreads();
        if (j + 1 < nkv) {""", """            cp_async_wait<1>();
        if (j + 1 < nkv) {""")],
    "no_copies": [("""        if (j + 1 < nkv) {
            load(2 * j + 2);""", """        if (j + 1 < 0) {
            load(2 * j + 2);""")],
}


def build(name: str, csrc: Path, edits, out_dir: Path):
    """Starts nvcc on a copy of csrc with the edits applied; returns (lib path, process)."""
    from saspa_tpu_torch.ops import _build

    src = out_dir / f"src_{name}"
    shutil.copytree(csrc, src)
    body = (src / SRC).read_text()
    for text, repl in edits:
        if text not in body:
            raise SystemExit(f"f32_core_probe: variant {name}: text not found in {SRC}: {text!r}")
        body = body.replace(text, repl)
    (src / SRC).write_text(body)
    lib = out_dir / f"lib{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src / SRC)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def load(lib: Path, build_py: Path):
    """K1 f32's entry of lib, with the C signature build_py (a checkout's ops/_build.py) gives it."""
    spec = importlib.util.spec_from_file_location("probe_build", build_py)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn_name, argtypes = mod.SIGNATURES["attention_f32"]
    fn = getattr(ctypes.CDLL(str(lib)), fn_name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn, len(argtypes) == 10  # (q, k, v, out, B, L, H, dp, d, stream): the entry takes the real head dim


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", type=int, nargs=4, default=[16, 4096, 8, 40], metavar=("B", "L", "H", "D"))
    ap.add_argument("--parent", type=Path, help="a checkout whose f32 core is timed beside these variants")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("f32_core_probe: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import H100_F32_FLOPS, f32_core_ptxas
    from saspa_tpu_torch.ops import attention as att

    b, l, h, d = args.shape
    dp = att.pad_head_dim(d)
    tmp = Path(tempfile.mkdtemp(prefix="f32_core_probe_"))
    try:
        jobs = {n: (build(n, ROOT / "saspa_tpu_torch/csrc", e, tmp), ROOT) for n, e in VARIANTS.items()}
        if args.parent:
            jobs["parent"] = (build("parent", args.parent / "saspa_tpu_torch/csrc", [], tmp), args.parent)
        fns = {}
        for n, ((lib, proc), root) in jobs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise SystemExit(f"f32_core_probe: nvcc failed for {n}:\n{err}")
            if n == "as_is":  # registers and spills of each instantiation
                print(json.dumps({"ptxas": f32_core_ptxas(err)}), flush=True)
            fns[n] = load(lib, root / "saspa_tpu_torch/ops/_build.py")
        gen = torch.Generator(device="cuda").manual_seed(0)

        def padded(x):
            return torch.nn.functional.pad(x, (0, dp - d)).reshape(b, l, h * dp).contiguous()

        q = padded(3.0 * torch.randn(b, l, h, d, generator=gen, device="cuda") * (att.LOG2E / math.sqrt(d)))
        k, v = (padded(torch.randn(b, l, h, d, generator=gen, device="cuda")) for _ in range(2))
        ref = att.flash_attention_packed_plain(q, k, v, h)
        stream = torch.cuda.current_stream().cuda_stream
        calls, rows = {}, {}
        for n, (fn, takes_d) in fns.items():
            out = torch.empty_like(q)
            dims = (b, l, h, dp, d) if takes_d else (b, l, h, dp)

            def call(fn=fn, out=out, dims=dims, n=n):
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *dims, stream)
                if err:
                    raise SystemExit(f"f32_core_probe: {n}: CUDA error {err}")

            call()
            torch.cuda.synchronize()
            rows[n] = {"variant": n, "B": b, "L": l, "H": h, "d": d, "d_pad": dp}
            if n in ("as_is", "parent"):
                rows[n]["max_abs_err"] = (out - ref).abs().max().item()
                rows[n]["ref_max"] = ref.abs().max().item()
                if rows[n]["max_abs_err"] > 1e-4 * rows[n]["ref_max"]:
                    raise SystemExit(f"f32_core_probe: {n} disagrees with the plain version: {rows[n]}")
            calls[n] = call
        times = {n: [] for n in calls}
        for turn in range(2):  # every variant twice, in order and then reversed
            for n in (list(calls) if turn == 0 else list(calls)[::-1]):
                for _ in range(2):
                    calls[n]()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(args.iters):
                    calls[n]()
                end.record()
                torch.cuda.synchronize()
                times[n].append(start.elapsed_time(end) / args.iters)
        bound_ms = 4.0 * b * h * l * l * d / H100_F32_FLOPS * 1e3  # the operations on the real d
        for n, row in rows.items():
            row.update(ms=min(times[n]), ms_turns=times[n], bound_ms=bound_ms, bound_share=bound_ms / min(times[n]))
            print(json.dumps(row), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    print(smi.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
