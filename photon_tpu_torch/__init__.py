"""photon_tpu_torch — the PyTorch/CUDA port of photon_tpu.

A second package beside the JAX one, written for one NVIDIA H100. It
imports ``torch`` and never ``jax``, and nothing of ``photon_tpu``; what
it needs from there it keeps as its own copy.

Entry points run on the card: ``device=None`` means
``torch.device("cuda")`` and raises ``RuntimeError`` when no card is
present. The CPU is used only when the caller passes ``device="cpu"``,
as the tests do; then every hand-written kernel takes its plain PyTorch
version.

Importing the package builds nothing: the CUDA kernels compile with
``nvcc`` at first use (``photon_tpu_torch/ops``).
"""
