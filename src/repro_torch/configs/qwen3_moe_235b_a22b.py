"""Qwen3-MoE-235B-A22B — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf].

Copy of ``repro.configs.qwen3_moe_235b_a22b``.  Too large for one card: the
port runs it ``.reduced()`` only.
"""

from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,          # per assignment: MoE expert FFN width
    vocab_size=151936,
    rope_theta=1000000.0,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=1536),
    source="hf:Qwen/Qwen3-30B-A3B; hf",
)
