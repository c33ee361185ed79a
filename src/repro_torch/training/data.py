"""Deterministic synthetic token batches (the port of
``repro.training.data``).

Token streams with a Zipfian unigram distribution and short-range
repetition: enough structure to exercise the training loop at full shapes
and to give activations realistic exponent statistics.  A batch is pure in
``(seed, step)``, so a run resumed from a checkpoint sees the batches an
uninterrupted run would.

A deliberate difference from the JAX package: JAX draws from
``jax.random`` (threefry), which this package cannot import.  Here every
batch comes from its own numpy generator seeded by ``(seed, step)``, with
the JAX stream's keys, shapes, dtypes and distribution but other numbers.
Parity tests feed both packages the same numpy batches.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    zipf_a: float = 1.2          # unigram exponent
    repeat_p: float = 0.25       # P(copy a recent token): adds structure


def _zipf_probs(vocab: int, a: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-a)
    return p / p.sum()


def _bf16(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(x.astype(np.float32)).to(device, torch.bfloat16)


class SyntheticTokenStream:
    """Stateless batch generator: ``batch_at(step)`` is pure in
    ``(seed, step)``.  Batches land on ``device`` (default: the card)."""

    def __init__(self, cfg: ArchConfig, shape: ShapeConfig,
                 data_cfg: DataConfig = DataConfig(),
                 device: DeviceLike = None):
        self.cfg = cfg
        self.shape = shape
        self.data_cfg = data_cfg
        self.device = resolve_device(device)
        self._probs = _zipf_probs(cfg.vocab_size, data_cfg.zipf_a)

    def batch_at(self, step: int, batch: Optional[int] = None,
                 seq: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """``{"tokens", "labels"}`` (B, S) int32; an audio config
        ``{"frames"`` (B, S, frontend_dim) bf16, ``"labels"}``; a vision
        config adds ``"patches"`` (B, frontend_len, frontend_dim) bf16 and
        keeps ``S - frontend_len`` text positions."""
        b = batch or self.shape.global_batch
        s = seq or self.shape.seq_len
        rng = np.random.default_rng([self.data_cfg.seed, step])
        cfg, dev, vocab = self.cfg, self.device, self.cfg.vocab_size

        def tokens(shape):
            return rng.choice(vocab, size=shape, p=self._probs).astype(np.int32)

        if cfg.frontend == "audio_frames":
            frames = rng.standard_normal((b, s, cfg.frontend_dim))
            labels = tokens((b, s))
            return {"frames": _bf16(frames, dev),
                    "labels": torch.from_numpy(labels).to(dev)}

        s_text = s - cfg.frontend_len if cfg.frontend == "vision_patches" else s
        toks = tokens((b, s_text + 1))
        # short-range repetition: with prob repeat_p copy the token 1..8 back
        lag = rng.integers(1, 9, size=toks.shape)
        idx = np.maximum(np.arange(s_text + 1)[None, :] - lag, 0)
        copied = np.take_along_axis(toks, idx, axis=1)
        mask = rng.random(toks.shape) < self.data_cfg.repeat_p
        toks = torch.from_numpy(np.where(mask, copied, toks).astype(np.int32))
        out = {"tokens": toks[:, :-1].contiguous().to(dev),
               "labels": toks[:, 1:].contiguous().to(dev)}
        if cfg.frontend == "vision_patches":
            out["patches"] = _bf16(rng.standard_normal(
                (b, cfg.frontend_len, cfg.frontend_dim)), dev)
        return out

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
