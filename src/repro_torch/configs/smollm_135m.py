"""SmolLM-135M — llama-arch small [hf:HuggingFaceTB/SmolLM-135M; hf]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-135m",
    family="dense",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab_size=49152,
    rope_theta=10000.0,
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M; hf",
)
