"""Architecture configuration: one dataclass drives every model family.

Counterpart of ``repro/models/config.py``, field for field, except that
``cim_use_pallas`` is ``cim_use_kernel`` (the CUDA kernels' routing) and
``paged_attn_use_kernel`` routes the paged-attention kernel.
Every family of the reference serves in this port.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from ..core.ccim import CCIMConfig


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                    # 0 -> d_model // n_heads

    # attention features
    rope_theta: float = 10000.0
    qk_norm: bool = False
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    sliding_window: Optional[int] = None
    layer_pattern: str = "global"      # "global" | "local_global"
    attn_impl: str = "flash"           # "flash" (blocked, O(S) memory) | "plain"
    flash_block: int = 512             # kv block of the flash loop
    prefix_lm: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    shared_expert_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.001

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # hybrid (zamba2)
    shared_attn_period: int = 0

    # frontends
    frontend: Optional[str] = None
    n_frontend_tokens: int = 0

    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    act: str = "silu"
    dtype: str = "bfloat16"

    # CIM execution mode
    cim_mode: bool = False             # run linear layers through the macro
    cim_fidelity: str = "fast"
    cim_cfg: Optional[CCIMConfig] = None   # None -> the 28nm prototype macro
    # None: CUDA kernels on CUDA tensors, plain version on CPU tensors;
    # False: plain version everywhere (the kernels' comparison run)
    cim_use_kernel: Optional[bool] = None
    # the paged-attention decode read, routed the same way (a port-only
    # field, like cim_use_kernel)
    paged_attn_use_kernel: Optional[bool] = None
    # deployment plan (repro_torch.plan.DeploymentPlan): each projection
    # path resolves to its own macro config and fidelity
    cim_plan: Optional[Any] = None
    cim_fuse: bool = True              # fuse QKV and gate/up into one GEMM
    cim_noise_seed: Optional[int] = None   # analog noise stream seed (fast)

    lr_schedule: str = "cosine"

    # TP head padding: head counts padded to a multiple of this with
    # zero-masked pad heads (the math is unchanged); reduced() sets 1
    tp_head_pad: int = 16

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def padded_heads(self) -> int:
        p = max(self.tp_head_pad, 1)
        return (self.n_heads + p - 1) // p * p if self.n_heads else 0

    @property
    def padded_kv_heads(self) -> int:
        if self.n_kv_heads and self.n_kv_heads == self.n_heads:
            return self.padded_heads           # MHA: pad kv with q
        return self.n_kv_heads                 # GQA: kv heads stay

    @property
    def q_per_kv(self) -> int:
        return max(1, self.n_heads // max(self.n_kv_heads, 1))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def layer_is_local(self, i: int) -> bool:
        return self.layer_pattern == "local_global" and i % 2 == 0

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test configuration of the same family (tiny dims)."""
        small = dict(
            n_layers=min(self.n_layers, 2 if self.shared_attn_period == 0 else 4),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads else 0,
            d_head=32,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            sliding_window=64 if self.sliding_window else None,
            n_experts=min(self.n_experts, 8),
            moe_d_ff=64 if self.n_experts else 0,
            shared_expert_d_ff=64 if self.n_shared_experts else 0,
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=32 if self.ssm_state else 64,
            ssm_chunk=32,
            shared_attn_period=2 if self.shared_attn_period else 0,
            n_frontend_tokens=8 if self.frontend else 0,
            flash_block=64,
            tp_head_pad=1,
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)
