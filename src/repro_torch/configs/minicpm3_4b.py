"""MiniCPM3-4B — MLA (multi-head latent attention) [hf:openbmb/MiniCPM3-4B; hf].

Copy of ``repro.configs.minicpm3_4b``.  The latent KV cache (kv_lora_rank +
rope dim per token) is itself the object SplitZip compresses on the PD
transfer path: MLA's lossy rank reduction and SplitZip's lossless exponent
coding compose.
"""

from repro_torch.configs.base import ArchConfig, MLAConfig

CONFIG = ArchConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,   # per assignment table; MLA replaces the KV projection
    head_dim=64,
    d_ff=6400,
    vocab_size=73448,
    rope_theta=10000.0,
    mla=MLAConfig(
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_nope_head_dim=64,
        qk_rope_head_dim=32,
        v_head_dim=64,
    ),
    source="hf:openbmb/MiniCPM3-4B; hf",
)
