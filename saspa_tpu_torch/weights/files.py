"""Public checkpoint files -> {key: numpy array} (counterpart of
tools/convert_weights.py::load_state_dict).

  * `.safetensors`: parsed here with numpy (the card's machine has no
    safetensors package): an 8-byte little-endian header length, the JSON
    header (`__metadata__` skipped), then the tensors at `data_offsets`
    counted from the end of the header.  F32, F16, BF16 and I64 are read;
    any other dtype raises.  The file is memory-mapped, so a 3.4 GB UNet is
    not copied before the converters transpose it.  BF16 has no numpy
    dtype: its bits go through torch.bfloat16 to float32 (exact).
  * TorchScript archives (OpenAI's RN50.pt): `torch.jit.load(...)
    .state_dict()`.
  * `.pth` / `.bin` pickles: `torch.load(map_location="cpu",
    weights_only=True)`; a nested `state_dict` or `model` entry is unwrapped
    and the `_orig_mod.` prefix of torch.compile stripped, as
    convert_weights does.  Other top-level tensors of the file (the WSDAN-CAL
    checkpoint's `feature_center`) are kept in the result's `extras`.
"""

from __future__ import annotations

import json
import struct
import zipfile
from pathlib import Path

import numpy as np
import torch

_SAFETENSORS_DTYPES = {"F32": np.float32, "F16": np.float16, "BF16": np.uint16, "I64": np.int64}
_UNWRAP = ("state_dict", "model")


class StateDict(dict):
    """{key: np.ndarray}, with the file's other top-level tensors in `extras`."""

    def __init__(self, items=(), extras=None):
        super().__init__(items)
        self.extras = dict(extras or {})


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v)


def read_safetensors(path) -> StateDict:
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    if not header:
        return StateDict()
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n)
    out = StateDict()
    for key, info in header.items():
        dt = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dt is None:
            raise ValueError(f"{path}: tensor {key} has dtype {info['dtype']}; read are {sorted(_SAFETENSORS_DTYPES)}")
        lo, hi = info["data_offsets"]
        arr = data[lo:hi].view(dt).reshape(info["shape"])
        if info["dtype"] == "BF16":
            arr = torch.from_numpy(np.array(arr)).view(torch.bfloat16).float().numpy()
        out[key] = arr
    return out


def write_safetensors(path, tensors) -> None:
    """{key: np.ndarray} (float32, float16 or int64) -> a .safetensors file."""
    names = {np.dtype(v): k for k, v in _SAFETENSORS_DTYPES.items() if k != "BF16"}
    header, offset, arrays = {}, 0, []
    for key, v in tensors.items():
        v = np.require(v, requirements="C")  # keeps 0-d arrays 0-d
        if v.dtype not in names:
            raise ValueError(f"{key}: no safetensors dtype for {v.dtype}")
        header[key] = {"dtype": names[v.dtype], "shape": list(v.shape), "data_offsets": [offset, offset + v.nbytes]}
        offset += v.nbytes
        arrays.append(v)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for v in arrays:
            f.write(memoryview(v).cast("B"))


def is_torchscript(path) -> bool:
    """A TorchScript archive is a zip holding the module's code and constants."""
    if not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as z:
        return any(n.endswith("constants.pkl") or "/code/" in n for n in z.namelist())


def read_state_dict(path) -> StateDict:
    """The tensors of one public checkpoint file as numpy arrays."""
    path = Path(path)
    if path.suffix == ".safetensors":
        return read_safetensors(path)
    if is_torchscript(path):
        return StateDict((k, _numpy(v)) for k, v in torch.jit.load(str(path), map_location="cpu").state_dict().items())
    return unwrap(torch.load(str(path), map_location="cpu", weights_only=True), path)


def unwrap(obj, path) -> StateDict:
    """A torch.load()ed checkpoint -> its state_dict as numpy."""
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: a {type(obj).__name__}, not a state_dict")
    extras = {}
    sd = obj
    for name in _UNWRAP:
        if isinstance(obj.get(name), dict):
            sd = obj[name]
            extras = {k: _numpy(v) for k, v in obj.items() if k != name and isinstance(v, torch.Tensor)}
            break
    return StateDict(((k.replace("_orig_mod.", ""), _numpy(v)) for k, v in sd.items()), extras)
