"""Qwen3-MoE-30B-A3B — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf].

Copy of ``repro.configs.qwen3_moe_30b_a3b``.  Also one of the paper's own
KV-transfer evaluation models (Fig. 3).
"""

from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,           # per assignment: MoE expert FFN width
    vocab_size=151936,
    rope_theta=1000000.0,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768),
    source="hf:Qwen/Qwen3-30B-A3B; hf",
)
