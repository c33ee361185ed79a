"""Pixtral-12B — ViT frontend (stub) + Mistral-Nemo-style text backbone
[hf:mistralai/Pixtral-12B-2409; unverified].

Copy of ``repro.configs.pixtral_12b``.  The vision frontend is a stub:
``make_inputs`` provides precomputed patch embeddings; the transformer
backbone is fully real.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1000000.0,
    frontend="vision_patches",
    frontend_dim=1024,   # pixtral ViT output width before the adapter
    frontend_len=256,    # patches per image at the assigned shapes
    source="hf:mistralai/Pixtral-12B-2409; unverified",
)
