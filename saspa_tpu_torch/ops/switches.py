"""The kernel routes and numerics of the generation path, as one record.

The JAX package selects them with environment variables read at trace time
(saspa_tpu/ops/groupnorm.py, attention.py, geglu.py, models/unet.py,
diffusion/sampler.py).  The port resolves the same variables, with the same
precedence, once, where a pipeline is built (`KernelSwitches.from_env`), and
hands the record to the models' constructors; no op reads the environment.

| Field | Variable (JAX's reading) | Route in the port |
| --- | --- | --- |
| pallas_group_norm | SASPA_PALLAS_GN == "1", unless SASPA_DISABLE_PALLAS_GN == "1" | K3 with the TPU kernel's numerics where `split_plan` admits the site |
| gn_fp32_norm | SASPA_GN_FP32_NORM == "1" | with the above: K3's TPU statistics, normalize and SiLU in f32 |
| attention_megakernel | SASPA_ATTN_MEGAKERNEL == "1" | K5 where `attention_block_eligible` admits the self-attention |
| disable_pallas | SASPA_DISABLE_PALLAS == "1" | no K1, K5, K6: every attention on the plain path at its real head dim |
| pallas_geglu | SASPA_PALLAS_GEGLU == "1" (unset: "1") | off: no K2; the block's feed-forward as torch ops after K4 |
| ln_fp32_norm | SASPA_LN_FP32_NORM == "1" | no K2, no K4: LayerNorm normalizes in f32 and casts once |
| cfg_full_batch | SASPA_CFG_FULL_BATCH == "1" | no CFG shared prefix: the model input is 2B from the first op |
| split_skip_concat | SASPA_SPLIT_SKIP_CONCAT == "1" | the up blocks' group-aligned skip concats are never built |

SASPA_PALLAS_LN needs no field: the port's LayerNorm (K4) computes what
both of JAX's routes compute.  The block and VMEM sizes and the
measurement probes (SASPA_GEGLU_NOGELU, SASPA_INIT_BF16) are not read.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Mapping, Optional


@dataclass(frozen=True)
class KernelSwitches:
    """The default record is what the JAX main path runs with no variable set."""
    pallas_group_norm: bool = False
    gn_fp32_norm: bool = False
    attention_megakernel: bool = False
    disable_pallas: bool = False
    pallas_geglu: bool = True
    ln_fp32_norm: bool = False
    cfg_full_batch: bool = False
    split_skip_concat: bool = False

    @classmethod
    def from_env(cls, env: Optional[Mapping[str, str]] = None) -> "KernelSwitches":
        """The record the JAX package would read from env (default os.environ)."""
        env = os.environ if env is None else env

        def on(name: str, default: str = "") -> bool:
            return env.get(name, default) == "1"

        return cls(
            pallas_group_norm=on("SASPA_PALLAS_GN") and not on("SASPA_DISABLE_PALLAS_GN"),
            gn_fp32_norm=on("SASPA_GN_FP32_NORM"),
            attention_megakernel=on("SASPA_ATTN_MEGAKERNEL"),
            disable_pallas=on("SASPA_DISABLE_PALLAS"),
            pallas_geglu=on("SASPA_PALLAS_GEGLU", "1"),
            ln_fp32_norm=on("SASPA_LN_FP32_NORM"),
            cfg_full_batch=on("SASPA_CFG_FULL_BATCH"),
            split_skip_concat=on("SASPA_SPLIT_SKIP_CONCAT"),
        )

    def replace(self, **changes) -> "KernelSwitches":
        return replace(self, **changes)

    @property
    def fused_ff(self) -> bool:
        """Whether the transformer blocks' norm3 + feed-forward run K2."""
        return self.pallas_geglu and not self.ln_fp32_norm


DEFAULT = KernelSwitches()
