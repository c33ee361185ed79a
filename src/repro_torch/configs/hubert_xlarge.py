"""HuBERT-XLarge — encoder-only audio transformer [arXiv:2106.07447; unverified].

Copy of ``repro.configs.hubert_xlarge``.  The conv waveform frontend is a
stub: ``make_inputs`` provides precomputed frame embeddings.  Encoder-only,
so there is no decode step; its serving path is encode-and-ship.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,     # MHA
    head_dim=80,
    d_ff=5120,
    vocab_size=504,      # masked-unit prediction targets
    encoder_only=True,
    frontend="audio_frames",
    frontend_dim=512,    # w2v2-style conv feature dim before projection
    source="arXiv:2106.07447; unverified",
)
