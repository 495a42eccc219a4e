"""The 10 architectures of the repository, as ``repro.configs.archs`` gives
them (exact configs from public literature; sources in brackets).

Each is selectable via ``--arch <id>`` in ``repro_torch.launch.serve``;
the port builds the dense, MoE, SSM and hybrid families (see
``repro_torch.models``); ``configs/<arch>.py`` gives ``CONFIG`` and
``SMOKE`` for the MoE, SSM and hybrid ones, as the reference does.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig

# [arXiv:2401.06066; hf] — fine-grained MoE: 2 shared + 64 routed top-6,
# first layer dense (d_ff 10944), expert dim 1408, MHA (kv=16).
DEEPSEEK_MOE_16B = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, dense_d_ff=10944, vocab_size=102_400,
    n_experts=64, n_experts_per_tok=6, n_shared_experts=2,
    first_dense_layers=1, rope_theta=10_000.0,
)

# [hf:meta-llama/Llama-4-Scout-17B-16E; unverified] — 16 routed top-1 +
# 1 shared expert every layer; GQA kv=8.
LLAMA4_SCOUT_17B = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab_size=202_048,
    n_experts=16, n_experts_per_tok=1, n_shared_experts=1,
    rope_theta=500_000.0,
)

# [arXiv:2308.11596; hf] — enc-dec text backbone (speech frontend stubbed:
# input_specs provides precomputed frame embeddings), 24L each side, MHA.
SEAMLESS_M4T_LARGE_V2 = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec-audio",
    n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=256_206, frontend="audio",
    rope_theta=10_000.0, mlp="gelu",
)

# [arXiv:2405.21060; unverified] — SSD (state-space duality), attn-free,
# d_inner = 2*d, head_dim 64 -> 32 SSD heads, state 128.
MAMBA2_370M = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50_280,
    ssm_state=128, ssm_expand=2, ssm_conv=4, ssm_head_dim=64,
    tie_embeddings=True,
)

# [arXiv:2408.00118; hf] — alternating local(4096)/global attention,
# attn softcap 50, final softcap 30, head_dim 256, GeGLU, pre+post norms.
GEMMA2_2B = ModelConfig(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=9216, vocab_size=256_000,
    attn_pattern=("local", "global"), local_window=4096,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    post_norm=True, tie_embeddings=True, rope_theta=10_000.0,
)

# [arXiv:2405.04324; hf] — code model, MQA (kv=1), wide FFN.
GRANITE_20B = ModelConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab_size=49_152, mlp="gelu",
    rope_theta=10_000.0,
)

# [hf:Qwen/Qwen2.5-0.5B scaled per spec; hf] — GQA kv=8, QKV bias.
QWEN25_32B = ModelConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=27648, vocab_size=152_064,
    qkv_bias=True, rope_theta=1_000_000.0,
)

# [arXiv:2407.14679; hf] — pruned nemotron; squared-ReLU MLP.
MINITRON_8B = ModelConfig(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=16384, vocab_size=256_000, mlp="relu2",
    rope_theta=10_000.0,
)

# [arXiv:2403.19887; hf] — Mamba+attn 1:7 interleave (attn at l%8==4),
# MoE 16e top-2 every other layer; mamba1-style state 16.
JAMBA_V01_52B = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=65_536,
    n_experts=16, n_experts_per_tok=2,
    moe_layer_period=2, moe_layer_offset=1,
    ssm_state=16, ssm_expand=2, ssm_conv=4, ssm_head_dim=64,
    attn_layer_period=8, attn_layer_offset=4,
)

# [hf:microsoft/Phi-3-vision-128k-instruct; hf] — phi3-mini backbone + CLIP
# frontend (stubbed: input_specs provides patch embeddings), MHA kv=32.
PHI3_VISION_4B = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32_064, frontend="vision",
    rope_theta=10_000.0,
)

ARCHS = {
    c.name: c
    for c in (
        DEEPSEEK_MOE_16B, LLAMA4_SCOUT_17B, SEAMLESS_M4T_LARGE_V2, MAMBA2_370M,
        GEMMA2_2B, GRANITE_20B, QWEN25_32B, MINITRON_8B, JAMBA_V01_52B,
        PHI3_VISION_4B,
    )
}


def smoke_config(full: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (small layers/width/
    experts/vocab, same structural features)."""
    import dataclasses

    kw: dict = dict(
        n_layers=max(2, min(4, full.n_layers)),
        d_model=64,
        d_ff=128 if full.d_ff else 0,
        dense_d_ff=192 if full.dense_d_ff else 0,
        vocab_size=128,
        head_dim=16,
        local_window=8,
    )
    if full.n_heads:
        kw.update(n_heads=4, n_kv_heads=max(1, min(full.n_kv_heads, 2) if full.n_kv_heads < full.n_heads else 4))
    if full.n_experts:
        # generous capacity so smoke tests are drop-free (exact decode parity)
        kw.update(n_experts=4, n_experts_per_tok=min(2, full.n_experts_per_tok),
                  moe_capacity_factor=4.0)
    if full.ssm_state:
        kw.update(ssm_state=8, ssm_head_dim=16)
    if full.n_enc_layers:
        kw.update(n_enc_layers=2)
    if full.attn_layer_period:
        kw.update(attn_layer_period=2, attn_layer_offset=1)
    if full.first_dense_layers:
        kw.update(first_dense_layers=1)
    return dataclasses.replace(full, **kw)
