"""SplitZip on PyTorch and CUDA: the port of :mod:`repro` to an NVIDIA H100.

The package mirrors the JAX package's layout (``configs/ core/ kernels/
models/ serving/ launch/``) and imports neither ``jax`` nor ``repro``.  The
four SplitZip codec kernels are hand-written CUDA C++ for ``sm_90a``
(``kernels/csrc/``), built with ``nvcc`` at first use; importing the package
never builds anything.

Entry points (``serving.engine.DisaggregatedEngine``, ``launch.serve``) run
on the card unless the caller passes ``device="cpu"``; without CUDA they
raise instead of falling back (:mod:`repro_torch.device`).
"""

from repro_torch.device import default_device, resolve_device

__all__ = ["default_device", "resolve_device"]
