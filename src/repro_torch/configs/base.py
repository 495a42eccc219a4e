"""Configs — the port's copy of ``repro.configs.base``: model
architectures, input shapes, parallelism knobs.

``ParallelConfig`` keeps every field of the reference. The trainer reads
``remat`` and ``microbatches``, and over data ranks ``zero_stage`` (0:
AdamW's state replicated, 1: sharded; the same bits either way).
``compress_pod_grads`` is stored and unread, as in the reference, where no
train step reads it (the int8 error-feedback all-reduce is the library
function ``train.compression.tree_compressed_psum``). ``shard_kv_seq`` and
``seq_shard_activations`` are declared and read nowhere, as in the
reference: the model axis's sequence-sharded decode cache and
context-parallel attention follow the cell's plan
(``launch.mesh.make_plan``) instead.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec-audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                     # query heads (0 for attn-free)
    n_kv_heads: int
    d_ff: int                        # dense-FFN hidden dim (per-expert dim for MoE)
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    # --- attention flavour ---
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    attn_pattern: Tuple[str, ...] = ("global",)   # cycled over layers
    local_window: int = 4096
    # --- MoE ---
    n_experts: int = 0
    n_experts_per_tok: int = 0
    n_shared_experts: int = 0
    dense_d_ff: int = 0              # dense FFN dim of non-MoE layers (deepseek l0)
    moe_layer_period: int = 1        # MoE every k-th layer
    moe_layer_offset: int = 0
    first_dense_layers: int = 0      # leading dense layers (deepseek: 1)
    router_aux_coef: float = 0.01
    moe_capacity_factor: float = 1.25
    moe_groups: int = 1              # dispatch groups (shard-local capacity)
    # --- SSM (mamba) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    attn_layer_period: int = 0       # hybrid: attention every k-th layer ...
    attn_layer_offset: int = 0       # ... at this offset (else mamba)
    # --- enc-dec / frontends ---
    n_enc_layers: int = 0
    frontend: str = ""               # "" | "audio" | "vision"
    mlp: str = "swiglu"              # swiglu | relu2 | gelu
    norm_eps: float = 1e-6
    post_norm: bool = False          # gemma2 style pre+post norms
    tie_embeddings: bool = False
    scan_layers: bool = True         # stacked repeated layer groups (the reference's layout)
    attn_chunk: int = 1024           # kv chunk of the plain chunked attention

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def padded_vocab_size(self) -> int:
        """Vocab padded to 128 (Megatron-style) so embeddings TP-shard and
        the unembed GEMM stays MXU-aligned."""
        return ((self.vocab_size + 127) // 128) * 128

    # ---- layer-type helpers ----
    def layer_kind(self, layer: int) -> str:
        """'attn' or 'mamba' for decoder layer `layer`."""
        if self.family == "ssm":
            return "mamba"
        if self.attn_layer_period:
            return (
                "attn"
                if layer % self.attn_layer_period == self.attn_layer_offset
                else "mamba"
            )
        return "attn"

    def layer_is_moe(self, layer: int) -> bool:
        if not self.n_experts:
            return False
        if layer < self.first_dense_layers:
            return False
        return layer % self.moe_layer_period == self.moe_layer_offset

    def attn_type(self, layer: int) -> str:
        return self.attn_pattern[layer % len(self.attn_pattern)]

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd, hq, hkv = self.head_dim, self.n_heads, self.n_kv_heads
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        n_dec = self.n_layers

        def attn_params() -> int:
            return d * hq * hd + 2 * d * hkv * hd + hq * hd * d

        def mlp_params(dff: int) -> int:
            return (3 if self.mlp == "swiglu" else 2) * d * dff

        for layer in range(n_dec):
            kind = self.layer_kind(layer)
            if kind == "attn":
                total += attn_params()
            else:
                d_in = self.ssm_expand * d
                n_h = d_in // self.ssm_head_dim
                total += (
                    d * (2 * d_in + 2 * self.ssm_state + n_h)  # in_proj
                    + self.ssm_conv * (d_in + 2 * self.ssm_state)  # conv
                    + d_in * d  # out_proj
                    + 3 * n_h  # A, D, dt_bias
                )
            if self.layer_is_moe(layer):
                total += self.n_experts * mlp_params(ff)
                total += self.n_shared_experts * mlp_params(ff)
                total += d * self.n_experts  # router
            else:
                total += mlp_params(self.dense_d_ff or ff)
            total += 2 * d  # norms
        for _ in range(self.n_enc_layers):
            total += attn_params() + mlp_params(ff) + 2 * d
            total += attn_params() + d  # decoder cross-attn + its norm
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k only)."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        d, ff = self.d_model, self.d_ff
        per_expert = (3 if self.mlp == "swiglu" else 2) * d * ff
        n_moe_layers = sum(self.layer_is_moe(l) for l in range(self.n_layers))
        inactive = n_moe_layers * (self.n_experts - self.n_experts_per_tok) * per_expert
        return full - inactive


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class ParallelConfig:
    """Distribution knobs resolved by the launcher per (arch × shape × mesh)."""
    remat: str = "block"             # none | block | dots
    microbatches: int = 1
    zero_stage: int = 1              # 0 = replicated opt state, 1 = sharded
    shard_kv_seq: bool = True        # decode: shard KV-cache sequence over 'model'
    compress_pod_grads: bool = True  # int8 error-feedback all-reduce on 'pod'
    seq_shard_activations: bool = False  # prefill: sequence-shard activations


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)
