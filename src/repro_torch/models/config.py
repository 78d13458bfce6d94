"""Unified model configuration (counterpart of ``repro.models.config``).

One frozen dataclass covers dense / MoE / VLM / audio / hybrid / SSM
families; per-family extras default off.  Exact numbers live in
``repro_torch.configs.<arch>`` — this module only defines the schema and
derived quantities (head_dim, padded vocab, parameter counts).  The schema
is the reference's whole, field for field; ``compute_dtype`` and
``params_dtype`` are ``torch.dtype``s.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch


def round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


# Per-layer kinds used by hybrid stacks.
ATTN = "attn"
MAMBA = "mamba"
MLSTM = "mlstm"
SLSTM = "slstm"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None   # default d_model // n_heads
    qk_norm: bool = False            # qwen3
    qkv_bias: bool = False           # qwen2
    sliding_window: Optional[int] = None   # h2o-danube
    rope_theta: float = 10_000.0
    mrope: bool = False              # qwen2-vl M-RoPE
    mrope_sections: Tuple[int, ...] = (16, 24, 24)   # t/h/w splits of head_dim//2
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    # MoE
    moe: bool = False
    n_experts: int = 0
    n_experts_active: int = 0        # top-k
    n_shared_experts: int = 0
    moe_d_ff: int = 0                # per-expert hidden dim
    moe_layer_period: int = 1        # MoE every `period` layers (jamba: 2)
    moe_capacity_factor: float = 1.25

    # hybrid (jamba): attention every `attn_layer_period` layers, Mamba else
    attn_layer_period: int = 0       # 0 => attention everywhere
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # ssm (xlstm): sLSTM at these indices, mLSTM elsewhere; d_ff == 0 means
    # the recurrent block carries its own up/down projection.
    slstm_at: Tuple[int, ...] = ()
    xlstm_proj_factor: float = 2.0

    # enc-dec (whisper): conv/patch frontends are STUBS per the assignment —
    # input_specs() hands the model precomputed frame/patch embeddings.
    encdec: bool = False
    n_encoder_layers: int = 0
    n_frontend_tokens: int = 0       # encoder frames (whisper) / image patches (vlm)

    dtype: str = "bfloat16"          # activation/compute dtype
    param_dtype: str = "float32"
    remat: bool = True               # checkpoint each block in train_step
    vocab_pad_to: int = 256          # Megatron-style padding for TP divisibility
    unroll: bool = False             # unroll layer scans (exact HLO cost
                                     # analysis — dry-run reduced configs only)

    # ------------------------------------------------------------------ derived
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return round_up(self.vocab_size, self.vocab_pad_to)

    @property
    def d_inner(self) -> int:        # mamba inner width
        return self.mamba_expand * self.d_model

    @property
    def compute_dtype(self) -> torch.dtype:
        return _torch_dtype(self.dtype)

    @property
    def params_dtype(self) -> torch.dtype:
        return _torch_dtype(self.param_dtype)

    def layer_kind(self, i: int) -> str:
        """Which mixer lives at layer ``i``."""
        if self.family == "ssm":
            return SLSTM if i in self.slstm_at else MLSTM
        if self.family == "hybrid" and self.attn_layer_period:
            # jamba: one attention layer per `attn_layer_period` (1:7 => period 8,
            # attention at offset period//2 like the release config)
            return ATTN if i % self.attn_layer_period == self.attn_layer_period // 2 else MAMBA
        return ATTN

    def layer_is_moe(self, i: int) -> bool:
        return self.moe and (i % self.moe_layer_period == self.moe_layer_period - 1)

    @property
    def attn_layers(self) -> Tuple[int, ...]:
        return tuple(i for i in range(self.n_layers) if self.layer_kind(i) == ATTN)

    @property
    def subquadratic(self) -> bool:
        """True if decode state does NOT grow linearly with full context
        (SWA / SSM / hybrid) — gates the long_500k shape."""
        if self.family in ("ssm",):
            return True
        if self.family == "hybrid":
            return True          # attn KV at 1:7 sparsity; state mostly SSM
        return self.sliding_window is not None

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # Rough parameter count (embedding + blocks), used for roofline 6ND.
    def param_count(self, active_only: bool = False) -> int:
        d, hd = self.d_model, self.hd
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        per_attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        per_dense_mlp = 3 * d * self.d_ff if self.d_ff else 0
        def moe_mlp(active: bool) -> int:
            e = self.n_experts_active if active else self.n_experts
            routed = 3 * d * self.moe_d_ff * e + d * self.n_experts
            shared = 3 * d * self.moe_d_ff * self.n_shared_experts
            return routed + shared
        per_mamba = (2 * d * self.d_inner          # in_proj
                     + self.d_inner * self.mamba_d_conv
                     + self.d_inner * (2 * self.mamba_d_state + 2)  # dt, B, C proj approx
                     + self.d_inner * d)           # out_proj
        pf = self.xlstm_proj_factor
        per_mlstm = int(d * d * pf * 2 + (d * pf) * d + 3 * (d * pf) * (d * pf) / max(1, self.n_heads))
        per_slstm = 4 * d * d + 4 * d
        total = emb
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            if kind == ATTN:
                total += per_attn
            elif kind == MAMBA:
                total += per_mamba
            elif kind == MLSTM:
                total += per_mlstm
            elif kind == SLSTM:
                total += per_slstm
            if kind in (ATTN, MAMBA):
                if self.layer_is_moe(i):
                    total += moe_mlp(active_only)
                elif self.d_ff:
                    total += per_dense_mlp
        if self.encdec:
            per_enc = per_attn + per_dense_mlp
            total += self.n_encoder_layers * per_enc + self.n_layers * per_attn  # cross-attn
        return total
