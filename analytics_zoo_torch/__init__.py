"""Analytics-Zoo on PyTorch and CUDA — the port of ``analytics_zoo_tpu``.

The layout mirrors the JAX package module for module, so each port
module's reference is the file of the same path there.  Plain tensor code
is PyTorch; every Pallas kernel the reference wrote for the TPU becomes a
hand-written CUDA kernel for Hopper (``csrc/``, built at first use by
``ops/kernels.py``), with its plain PyTorch version beside it.

The port imports neither ``jax`` nor ``analytics_zoo_tpu``.  Its entry
points run on ``cuda:0`` unless the caller asks for the CPU
(``init_zoo_context(device="cpu")``).
"""

from analytics_zoo_torch.common.zoo_context import (
    ZooContext,
    get_zoo_context,
    init_zoo_context,
    reset_zoo_context,
)

__version__ = "0.1.0"

__all__ = ["__version__", "init_zoo_context", "get_zoo_context",
           "reset_zoo_context", "ZooContext"]
