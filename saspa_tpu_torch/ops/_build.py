"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` compiles with nvcc into its own shared library with a
plain C interface (`_build/lib<name>-<hash>.so`, the hash taken over the
sources so an edit forces a rebuild), and is loaded through ctypes.  Nothing
is built at import time: the first wrapper call on a CUDA tensor builds its
library, and `build_all()` builds every kernel at once, one nvcc process per
source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# C signatures: every pointer and the stream are c_void_p (a c_int would cut
# a 64-bit address), counts are c_int (each count passed is a dimension, far
# below 2^31; the kernels form element offsets in 64 bits), eps and scale
# are c_float.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "attention_packed": ("saspa_attention_packed", [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "attention_packed_f32": ("saspa_attention_packed_f32", [_P, _P, _P, _P, _I, _I, _I, _P]),
    "ln_geglu": ("saspa_ln_geglu", [_P] * 10 + [_I] * 7 + [_F, _P]),
    "group_norm": ("saspa_group_norm", [_P] * 5 + [_I] * 7 + [_F, _I, _I, _I, _P]),
    "layernorm": ("saspa_layernorm", [_P] * 4 + [_I] * 5 + [_F, _I, _P]),
    "attention_block": ("saspa_attention_block", [_P] * 9 + [_I] * 5 + [_P]),
    "flash_attention": ("saspa_flash_attention", [_P] * 4 + [_I] * 6 + [_F, _P]),
    "attention_f32": ("saspa_attention_f32_packed", [_P] * 4 + [_I] * 5 + [_P]),
}
# a library's C entry points beside its first: name -> {function: argtypes}
MORE_ENTRIES = {
    "attention_f32": {"saspa_flash_attention_f32": [_P] * 4 + [_I] * 5 + [_F, _P],
                      "saspa_attention_block_f32": [_P] * 9 + [_I] * 6 + [_P]},
}

KERNELS = tuple(SIGNATURES)

_lock = threading.Lock()
_loaded: dict = {}
build_log: dict = {}  # name -> nvcc's stderr (register / spill report from -Xptxas -v), kept beside the library


def _nvcc() -> str:
    found = shutil.which("nvcc") or str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    out = _lib_path(name)
    if out.exists():
        log = out.with_suffix(".log")
        if log.exists():
            build_log[name] = log.read_text()
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return out, (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))


def _finish(name: str, out: Path, job) -> None:
    if job is None:
        return
    tmp, proc = job
    stdout, stderr = proc.communicate()
    build_log[name] = stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{stdout}\n{stderr}")
    out.with_suffix(".log").write_text(stderr)
    os.replace(tmp, out)


def _load(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in (SIGNATURES[name], *MORE_ENTRIES.get(name, {}).items()):
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def build_all() -> float:
    """Builds (in parallel) and loads every kernel; returns the seconds taken."""
    t0 = time.perf_counter()
    with _lock:
        todo = [n for n in KERNELS if n not in _loaded]
        jobs = {n: _start(n) for n in todo}
        for n, (out, job) in jobs.items():
            _finish(n, out, job)
        for n, (out, _) in jobs.items():
            _loaded[n] = _load(n, out)
    return time.perf_counter() - t0


def kernel(name: str, entry: str = ""):
    """The C entry point of one kernel (its first, or `entry`), building its
    library on first use."""
    if name not in _loaded:
        with _lock:
            if name not in _loaded:
                out, job = _start(name)
                _finish(name, out, job)
                _loaded[name] = _load(name, out)
    return getattr(_loaded[name], entry or SIGNATURES[name][0])


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
