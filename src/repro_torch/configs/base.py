"""Architecture + shape configuration system (copy of ``repro.configs.base``).

The dataclasses are data only and copied verbatim, so a config means the same
model in both packages.  ``get_config`` resolves every architecture of the
JAX package: dense GQA (smollm-135m, llama3.2-3b, minitron-4b, qwen3-32b),
MLA (minicpm3-4b), MoE (qwen3-moe-30b-a3b, qwen3-moe-235b-a22b), SSM
(mamba2-2.7b), the RG-LRU + local-attention hybrid (recurrentgemma-9b) and
the frontend families (pixtral-12b behind vision patches, the encoder-only
hubert-xlarge behind audio frames).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 128
    top_k: int = 8
    d_ff_expert: int = 1536          # per-expert FFN hidden
    capacity_factor: float = 1.25    # dispatch slot headroom


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    n_groups: int = 1
    chunk: int = 256                 # SSD chunk length


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    # RecurrentGemma / Griffin: repeating (recurrent, recurrent, attention)
    pattern: Tuple[str, ...] = ("rglru", "rglru", "local_attn")
    window: int = 2048
    lru_width: Optional[int] = None  # defaults to d_model
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | vlm | hybrid | audio | ssm
    num_layers: int
    d_model: int
    num_heads: int                   # 0 for attention-free
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    encoder_only: bool = False       # hubert: no decode phase
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    # modality frontend stubs (DESIGN.md §4): precomputed embeddings
    frontend: Optional[str] = None   # None | 'vision_patches' | 'audio_frames'
    frontend_dim: int = 0            # dim of precomputed frontend features
    frontend_len: int = 256          # frontend positions per example
    source: str = ""

    # ---- derived -----------------------------------------------------------
    @property
    def attention_free(self) -> bool:
        return self.ssm is not None

    @property
    def sub_quadratic(self) -> bool:
        """True if long-context (500k) serving is in scope (DESIGN.md §4)."""
        return self.ssm is not None or self.hybrid is not None

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks + head)."""
        d, l = self.d_model, self.num_layers
        n = self.vocab_size * d  # embed
        if not self.tie_embeddings and not self.encoder_only:
            n += d * self.vocab_size
        if self.ssm is not None:
            di = self.ssm.expand * d
            heads = di // self.ssm.head_dim
            per = (d * (2 * di + 2 * self.ssm.n_groups * self.ssm.d_state + heads)
                   + di * d + 3 * heads + di * self.ssm.conv_width)
            n += l * per
            return n
        hd = self.head_dim
        if self.mla is not None:
            m = self.mla
            per_attn = (d * m.q_lora_rank
                        + m.q_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                        + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                        + m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
                        + self.num_heads * m.v_head_dim * d)
        else:
            per_attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd \
                + self.num_heads * hd * d
        if self.moe is not None:
            per_ffn = (d * self.moe.num_experts
                       + self.moe.num_experts * 3 * d * self.moe.d_ff_expert)
        else:
            per_ffn = 3 * d * self.d_ff
        if self.hybrid is not None:
            h = self.hybrid
            lru = h.lru_width or d
            n_rec = sum(1 for i in range(l) if h.pattern[i % len(h.pattern)] == "rglru")
            n_att = l - n_rec
            per_rec = d * lru * 2 + lru * d + lru * h.conv_width + 3 * lru + per_ffn
            per_att = per_attn + per_ffn
            n += n_rec * per_rec + n_att * per_att
            return n
        n += l * (per_attn + per_ffn)
        return n

    def active_param_count(self) -> int:
        """MoE: only top_k of num_experts fire per token."""
        if self.moe is None:
            return self.param_count()
        d, l = self.d_model, self.num_layers
        dense = self.param_count() - l * self.moe.num_experts * 3 * d * self.moe.d_ff_expert
        return dense + l * self.moe.top_k * 3 * d * self.moe.d_ff_expert

    def with_layers(self, num_layers: int) -> "ArchConfig":
        """Same config at a different depth (dry-run cost extrapolation).
        For hybrid archs, pass a multiple of the block pattern length."""
        return dataclasses.replace(self, num_layers=num_layers)

    def reduced(self) -> "ArchConfig":
        """Small same-family config for CPU smoke tests."""
        kw = dict(
            name=self.name + "-reduced",
            family=self.family,
            num_layers=min(self.num_layers, 2),
            d_model=128,
            num_heads=min(self.num_heads, 4) if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            d_ff=256,
            vocab_size=128,
            head_dim=32,
            encoder_only=self.encoder_only,
            frontend=self.frontend,
            frontend_dim=min(self.frontend_dim, 64) if self.frontend_dim else 0,
            frontend_len=8,
        )
        if self.moe is not None:
            # capacity_factor high enough to be dropless at smoke-test sizes,
            # so decode-vs-forward consistency is exact
            kw["moe"] = MoEConfig(num_experts=8, top_k=2, d_ff_expert=64,
                                  capacity_factor=8.0)
        if self.mla is not None:
            kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                  qk_nope_head_dim=16, qk_rope_head_dim=8,
                                  v_head_dim=16)
        if self.ssm is not None:
            kw["ssm"] = SSMConfig(d_state=16, head_dim=16, expand=2,
                                  conv_width=4, chunk=8)
        if self.hybrid is not None:
            kw["hybrid"] = HybridConfig(window=8, lru_width=128)
            kw["num_layers"] = 3  # one full (rglru, rglru, local_attn) pattern
        return ArchConfig(**kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = (
    "minitron-4b",
    "smollm-135m",
    "llama3.2-3b",
    "minicpm3-4b",
    "qwen3-moe-235b-a22b",
    "qwen3-moe-30b-a3b",
    "pixtral-12b",
    "recurrentgemma-9b",
    "hubert-xlarge",
    "mamba2-2.7b",
)

#: every architecture of ``ARCH_IDS`` and the paper's own eval model
PORTED = {
    "minitron-4b": "repro_torch.configs.minitron_4b",
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "llama3.2-3b": "repro_torch.configs.llama3_2_3b",
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b_a22b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "pixtral-12b": "repro_torch.configs.pixtral_12b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    "qwen3-32b": "repro_torch.configs.qwen3_32b",  # paper's own eval model
}


def get_config(arch: str) -> ArchConfig:
    if arch not in PORTED:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(PORTED)}")
    return importlib.import_module(PORTED[arch]).CONFIG


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """DESIGN.md §4 skip rules (the JAX ``shape_applicable``).  Returns
    (applicable, reason_if_not)."""
    if shape.kind == "decode" and cfg.encoder_only:
        return False, "encoder-only arch has no autoregressive decode step"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "524k context requires sub-quadratic attention (SSM/hybrid only)"
    return True, ""


def cells(arch_ids=ARCH_IDS):
    """All live (arch, shape) dry-run cells."""
    out = []
    for a in arch_ids:
        cfg = get_config(a)
        for s in SHAPES.values():
            ok, _ = shape_applicable(cfg, s)
            if ok:
                out.append((a, s.name))
    return out
