"""Context initialisation — the ``NNContext`` equivalent, PyTorch port.

The reference package's ``init_zoo_context`` resolves the layered config,
brings up ``jax.distributed`` and builds the device mesh.  This slice of
the port is single-device: the context resolves the config, picks the
device every entry point places its tensors on, and applies the numeric
policy (no TF32 anywhere: float32 products stay float32).  Multi-process
bring-up and the mesh come with the multi-GPU slice.

Idempotent like the reference: repeated calls return the live context.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Optional

import torch

from analytics_zoo_torch.common.config import ZooConfig, set_config

log = logging.getLogger("analytics_zoo_torch")

DEFAULT_DEVICE = "cuda:0"


class ZooContext:
    """Live runtime context: config + the one device the port runs on."""

    def __init__(self, config: ZooConfig, device: torch.device):
        self.config = config
        self.device = device

    def __repr__(self):
        return f"ZooContext(device={self.device})"


_context: Optional[ZooContext] = None


def _resolve_device(device) -> torch.device:
    dev = torch.device(device if device is not None else DEFAULT_DEVICE)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"init_zoo_context: device {dev} requested but CUDA is not "
                "available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use cuda[:N] or cpu")
    return dev


def init_zoo_context(conf: Optional[Dict[str, Any]] = None,
                     conf_file: Optional[str] = None,
                     device=None,
                     name: str = "Analytics Zoo Torch") -> ZooContext:
    """Create (or return) the global context.

    ``device`` defaults to ``cuda:0``; with no GPU that raises unless the
    caller asks for ``device="cpu"``.  A live context is returned as it
    is; asking it for another device raises."""
    global _context
    if _context is not None:
        if device is not None and \
                _resolve_device(device) != _context.device:
            raise ValueError(
                f"zoo context already lives on {_context.device}; "
                "reset_zoo_context() before switching devices")
        return _context

    dev = _resolve_device(device)
    from analytics_zoo_torch.common import config as config_mod
    prior = getattr(config_mod._global_config, "_programmatic", None) \
        if config_mod._global_config is not None else None
    merged = {**(prior or {}), **(conf or {})}
    config = ZooConfig(conf_file=conf_file, overrides=merged or None)
    set_config(config)

    # float32 products stay float32: the reference numerics are exact f32
    # (bf16 only where the dtype policy rounds operands on purpose)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda":
        torch.cuda.set_device(dev)

    _context = ZooContext(config, dev)

    # the cluster observability plane, as in the reference: when a
    # launcher or a serving supervisor hands this process a run dir,
    # stamp its host/process_index labels on the registry, start its
    # metrics endpoint and recorder and sample the TSDB into its slot
    # (the process index from ZOO_TPU_PROCESS_ID: one device a process).
    # Best-effort: a broken metrics port must never stop the process
    if os.environ.get("ZOO_TPU_RUN_DIR"):
        try:
            from analytics_zoo_torch.observability.aggregator import (
                init_worker_observability)
            init_worker_observability()
        except Exception:   # noqa: BLE001
            log.exception("cluster observability bring-up failed")

    log.info("%s initialised: %r", name, _context)
    return _context


def get_zoo_context() -> ZooContext:
    """Return the live context, initialising with defaults if needed."""
    if _context is None:
        return init_zoo_context()
    return _context


def reset_zoo_context() -> None:
    """Drop the global context (test helper)."""
    global _context
    _context = None
