"""Mamba2-2.7B — SSD (state-space duality), attention-free
[arXiv:2405.21060; unverified].

Copy of ``repro.configs.mamba2_2_7b``.  The transferred state is the SSM
state (B, heads, head_dim, d_state) in f32 and the conv state in bf16, both
independent of the context length; SplitZip compresses the conv state, and
the SSM state's hi halves when ``compress_fp32`` is on.
"""

from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,         # attention-free
    num_kv_heads=0,
    d_ff=0,              # no separate MLP; SSD block carries the capacity
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4,
                  n_groups=1, chunk=256),
    source="arXiv:2405.21060; unverified",
)
