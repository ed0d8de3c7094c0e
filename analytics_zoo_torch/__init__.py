"""Analytics-Zoo on PyTorch and CUDA — the port of ``analytics_zoo_tpu``.

The layout mirrors the JAX package module for module, so each port
module's reference is the file of the same path there.  Plain tensor code
is PyTorch; every Pallas kernel the reference wrote for the TPU becomes a
hand-written CUDA kernel for Hopper (``csrc/``, built at first use by
``ops/kernels.py``), with its plain PyTorch version beside it.

The port imports neither ``jax`` nor ``analytics_zoo_tpu``.  Its entry
points run on ``cuda:0`` unless the caller asks for the CPU
(``init_zoo_context(device="cpu")``).

The context names are imported on first use, so a stdlib-only module of
the package (the batch tier's ledger and report) loads without torch.
"""

__version__ = "0.1.0"

_CONTEXT_NAMES = ("ZooContext", "get_zoo_context", "init_zoo_context",
                  "reset_zoo_context")


def __getattr__(name):
    if name in _CONTEXT_NAMES:
        from analytics_zoo_torch.common import zoo_context
        return getattr(zoo_context, name)
    raise AttributeError(f"module 'analytics_zoo_torch' has no attribute "
                         f"{name!r}")


__all__ = ["__version__", "init_zoo_context", "get_zoo_context",
           "reset_zoo_context", "ZooContext"]
