"""Float32 matmul precision on the card from a JAX precision name, shared
by the Trainer (``training.matmul_precision``) and the generator
(``generation.matmul_precision``)."""

from __future__ import annotations

import contextlib

import torch

# JAX precision name → TF32 allowed on the card (jax.lax.Precision on a GPU:
# DEFAULT and HIGH use TF32 where the card has it, HIGHEST full float32).
# The keys are the names jax.default_matmul_precision accepts; any other
# raises, as it does there.
TF32 = {"default": True, "bfloat16": True, "high": True, "tensorfloat32": True,
        "highest": False, "float32": False}


@contextlib.contextmanager
def matmul_precision(name):
    """Set cuBLAS's and cuDNN's TF32 flags from a JAX precision name for
    the block, then restore the process's own. Float32 work on the CPU is
    unaffected."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = TF32[name]
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
