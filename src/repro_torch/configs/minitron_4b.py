"""Minitron-4B — width/depth-pruned Nemotron [arXiv:2407.14679; hf].

Copy of ``repro.configs.minitron_4b``: dense GQA (24 query heads over 8 KV
heads of 128).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    rope_theta=10000.0,
    source="arXiv:2407.14679; hf",
)
