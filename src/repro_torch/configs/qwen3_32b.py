"""Qwen3-32B — the paper's main codec/ablation evaluation model (§4.1).

Not part of the assigned 10-arch pool; included because every SplitZip
table/figure except Fig. 3 uses its KV tensors, so the benchmark suite needs
the config to generate authentic-geometry KV activations.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    rope_theta=1000000.0,
    source="hf:Qwen/Qwen3-32B; paper §4.1",
)
