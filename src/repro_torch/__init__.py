"""PyTorch port of the QNIHT system for NVIDIA Hopper (H100).

Mirrors the module layout of the JAX package ``repro`` (the reference), so the
counterpart of ``repro.core.niht`` is ``repro_torch.core.niht`` and so on. The
port imports ``torch`` and numpy only: never ``jax`` and nothing of ``repro``.

Functions that create tensors default to ``device="cuda"`` and raise when no
GPU is present; pass ``device="cpu"`` to run on the CPU (the tests do). On a
CUDA tensor the packed matmul launches the hand-written Hopper kernel
(``repro_torch.kernels.qmm``); on a CPU tensor it runs its plain PyTorch
version.
"""
