"""Card-only check of the training step (skips without a GPU).

A reduced smollm train step on the card against the same step on the CPU,
from the same parameters and batch: loss within 2e-3, grad norm within
rtol 5e-3 and each parameter leaf within a relative L2 norm of 5e-3 (the
bounds ``tests/test_torch_train.py`` states for the port against JAX: the
card's matmuls accumulate in another order, and an element whose first
AdamW update is about lr times the gradient's sign can go the other way).
The flash-attention kernel is never launched: training attends through
``chunked_attention`` under autograd.  No JAX here, so this file runs on
the card machine.
"""

import pytest
import torch

from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.core import tree as TR
from repro_torch.kernels import flash_attention as FA
from repro_torch.training import optimizer as OPT
from repro_torch.training import train_step as TS
from repro_torch.training.data import SyntheticTokenStream


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the training step on the card")
    return torch.device("cuda", 0)


def _rel(a, b) -> float:
    a, b = a.float().cpu(), b.float().cpu()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.clamp(torch.linalg.vector_norm(a), min=1e-30))


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(cuda_device):
    cfg = get_config("smollm-135m").reduced()
    state = TS.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = SyntheticTokenStream(cfg, ShapeConfig("t", 32, 4, "train"),
                                 device="cpu").batch_at(0)
    step = TS.make_train_step(cfg, OPT.AdamWConfig(lr=3e-4, total_steps=2,
                                                   warmup_steps=1), kv_block=32)
    on_card = TR.unflatten(TR.flatten_with_path(state)[1],
                           [x.to(cuda_device) for x in TR.leaves(state)])
    before = FA.flash_attention.launches
    got, gm = step(on_card, {k: v.to(cuda_device) for k, v in batch.items()})
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before
    want, wm = step(state, batch)
    assert abs(float(gm["loss"]) - float(wm["loss"])) <= 2e-3
    assert abs(float(gm["grad_norm"]) / float(wm["grad_norm"]) - 1) <= 5e-3
    assert float(gm["lr"]) == float(wm["lr"])
    for a, b in zip(TR.leaves(want.params), TR.leaves(got.params)):
        assert b.device.type == "cuda" and b.dtype == a.dtype
        assert _rel(a, b) <= 5e-3


@pytest.mark.cuda
def test_embedding_gradient_sums_in_f32_on_card(cuda_device):
    """The token lookup's backward on the card sums a token's rows in f32
    and rounds once: within one bf16 rounding of an f32 ``index_add_``,
    with one token taking half the batch (indexing's backward adds the
    rows in bf16 and drifts on such a token)."""
    from repro_torch.models import model as M
    cfg = get_config("smollm-135m").reduced()
    g = torch.Generator(device=cuda_device).manual_seed(0)
    w = (torch.randn(cfg.vocab_size, cfg.d_model, generator=g,
                     device=cuda_device) * 0.02).to(torch.bfloat16)
    w.requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab_size, (8, 1024), generator=g,
                           device=cuda_device, dtype=torch.int32)
    tokens[:, ::2] = 0
    up = torch.randn(8, 1024, cfg.d_model, generator=g,
                     device=cuda_device).to(torch.bfloat16)
    x = M.embed_inputs({"embed": w}, {"tokens": tokens}, cfg)
    (x.float() * up.float()).sum().backward()
    ref = torch.zeros(w.shape, device=cuda_device).index_add_(
        0, tokens.reshape(-1).long(), up.reshape(-1, cfg.d_model).float())
    assert _rel(ref, w.grad) <= 2 ** -8
