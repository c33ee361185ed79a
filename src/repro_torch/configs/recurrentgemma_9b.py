"""RecurrentGemma-9B — RG-LRU + local attention, 2:1 pattern
[arXiv:2402.19427; unverified].

Copy of ``repro.configs.recurrentgemma_9b``: 12 (rglru, rglru, local_attn)
triples and 2 extra recurrent blocks; the local attention is MQA (16 heads
over one KV head of 256) inside a 2048-token window.
"""

from repro_torch.configs.base import ArchConfig, HybridConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,      # MQA in the local-attention layers
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    rope_theta=10000.0,
    hybrid=HybridConfig(
        pattern=("rglru", "rglru", "local_attn"),
        window=2048,
        lru_width=4096,
        conv_width=4,
    ),
    source="arXiv:2402.19427; unverified",
)
