"""Parameters and train states from the JAX package, as numpy, into the
port's layout.

Both packages keep the same nested-dict parameter tree with the same shapes,
so the conversion is per-array: bf16 arrays (``ml_dtypes.bfloat16``, or
their ``uint16`` bit patterns) become ``torch.bfloat16`` with identical
bits, float32 stays float32.  The caller converts the JAX tree to numpy
(``jax.tree.map(np.asarray, params)``), so this module needs no JAX.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _tensor(arr: np.ndarray, device) -> torch.Tensor:
    arr = np.array(arr, order="C")   # a writable copy: JAX's buffers are read-only
    if arr.dtype.name in ("bfloat16", "uint16"):
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_jax(np_tree: Any, device=None, policy=None) -> Any:
    """Map a numpy copy of ``repro.models.model.init_params``'s tree onto
    tensors on ``device`` (default CPU).  ``policy`` (a
    ``distributed.sharding.ShardingPolicy``): only this rank's block of
    each leaf (``sharding.param_placer``, the cut ``init_params(place=)``
    makes of its own draws), so a rank holds the bytes its specs give."""
    if policy is None:
        place = None
    else:
        from repro_torch.distributed.sharding import param_placer
        place = param_placer(policy)

    def conv(keys, tree):
        if isinstance(tree, dict):
            return {k: conv(keys + (k,), v) for k, v in tree.items()}
        x = _tensor(np.asarray(tree), device)
        return x if place is None else place(keys, x)
    return conv((), np_tree)


def train_state_from_jax(np_state: Any, device=None):
    """Map a numpy copy of ``repro.training.train_step.TrainState``
    (``params``, ``AdamWState(step int32, m f32, v f32)``) onto the port's
    ``TrainState`` on ``device`` (default CPU), every leaf's bits kept."""
    from repro_torch.training.optimizer import AdamWState
    from repro_torch.training.train_step import TrainState
    params, (step, m, v) = np_state
    return TrainState(params=params_from_jax(params, device),
                      opt=AdamWState(step=_tensor(np.asarray(step), device),
                                     m=params_from_jax(m, device),
                                     v=params_from_jax(v, device)))
