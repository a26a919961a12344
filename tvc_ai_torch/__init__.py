"""PyTorch/CUDA port of the rocket thrust-vector-control digital twin.

The JAX package ``tvc_ai_tpu`` is the reference this package is held
against; the layout mirrors it module for module (``physics``, ``ops``,
``env``, ``models``, ``agents``, ``training``, ``eval``, ``config``) so each
counterpart is found under the same path. This package imports ``torch``,
numpy and PyYAML (matplotlib, tensorboardX, psutil and wandb only where
present) — never JAX, flax, optax or anything from ``tvc_ai_tpu`` — and
keeps its own copy of every constant and config file it needs.

Entry points take ``device=`` and default to ``"cuda"``; they raise when no
CUDA device is present unless the caller asks for ``"cpu"`` (the CPU path is
for tests). The integrate + contact step runs as a hand-written CUDA kernel
(``ops.step_kernel``, source ``csrc/step_kernel.cu``) on CUDA tensors.
"""

__version__ = "0.1.0"
