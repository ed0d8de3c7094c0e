"""Context initialisation — the ``NNContext`` equivalent, PyTorch port.

The reference package's ``init_zoo_context`` resolves the layered config,
brings up ``jax.distributed`` and builds the device mesh.  The port does
the same on ``torch.distributed``, one process a device: the context
resolves the config; when the launcher's contract is in the environment
(``ZOO_TPU_NUM_PROCESSES`` > 1 and ``ZOO_TPU_COORDINATOR``, with
``ZOO_TPU_PROCESS_ID``) it joins the process group, over NCCL on the
card and gloo where the caller asks for the CPU; it picks the device
every entry point places its tensors on (the local rank's card unless
the caller names one), builds the mesh
from ``mesh_shape`` or the ``mesh.shape`` key (default: every rank on
``data``), and applies the numeric policy (no TF32 anywhere: float32
products stay float32).

The coordinator is ``host:port`` (rank 0 serves a TCP store there) or a
``file://`` path (a file store every rank can reach); the group's
operations time out after ``parallel.timeout_s``.

Idempotent like the reference: repeated calls return the live context.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Optional

import torch

from analytics_zoo_torch.common.config import ZooConfig, set_config

log = logging.getLogger("analytics_zoo_torch")


class ZooContext:
    """Live runtime context: config, this process's device, the mesh and
    the process topology."""

    def __init__(self, config: ZooConfig, device: torch.device, mesh=None):
        from analytics_zoo_torch.parallel.mesh import trivial_mesh
        self.config = config
        self.device = device
        self.mesh = mesh if mesh is not None else trivial_mesh()

    @property
    def process_index(self) -> int:
        return self.mesh.rank

    @property
    def process_count(self) -> int:
        return self.mesh.world_size

    @property
    def num_devices(self) -> int:
        return self.mesh.world_size

    @property
    def is_coordinator(self) -> bool:
        return self.process_index == 0

    def __repr__(self):
        return (f"ZooContext(device={self.device}, "
                f"processes={self.process_count}, "
                f"mesh={self.mesh.shape})")


_context: Optional[ZooContext] = None


def _resolve_device(device, rank: int = 0) -> torch.device:
    if device is None:
        # the local rank's card (ranks beyond the cards share them round
        # robin: two ranks on one card is the single-card rehearsal)
        n = torch.cuda.device_count() if torch.cuda.is_available() else 1
        device = f"cuda:{rank % max(n, 1)}"
    dev = torch.device(device)
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


def _init_method(coordinator: str) -> str:
    if "://" in coordinator:
        return coordinator
    return f"tcp://{coordinator}"


def init_process_group(coordinator: str, world_size: int, rank: int,
                       device: torch.device,
                       backend: Optional[str] = None) -> None:
    """Join (or, as rank 0 of a ``host:port`` coordinator, serve) the
    process group: NCCL for a CUDA device, gloo for the CPU, unless
    ``backend`` names one.  A caller that wants another backend than the
    device's joins here before ``init_zoo_context``, which then keeps the
    live group."""
    import datetime

    import torch.distributed as dist
    from analytics_zoo_torch.common.config import get_config
    cfg = get_config()
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    timeout = datetime.timedelta(seconds=float(cfg.get("parallel.timeout_s")))
    dist.init_process_group(backend, init_method=_init_method(coordinator),
                            world_size=int(world_size), rank=int(rank),
                            timeout=timeout)
    log.info("joined the %s process group as rank %d of %d", backend, rank,
             world_size)


def _mesh_shape_from_config(config) -> Optional[Dict[str, int]]:
    raw = config.get("mesh.shape")
    if not raw or raw == "auto":
        return None
    shape = {}
    for part in str(raw).split(","):
        ax, s = part.split(":")
        shape[ax.strip()] = int(s)
    return shape


def init_zoo_context(conf: Optional[Dict[str, Any]] = None,
                     conf_file: Optional[str] = None,
                     device=None,
                     mesh_shape: Optional[Dict[str, int]] = None,
                     name: str = "Analytics Zoo Torch") -> ZooContext:
    """Create (or return) the global context.

    ``device`` defaults to the local rank's card (``cuda:0`` in one
    process); with no GPU that raises unless the caller asks for
    ``device="cpu"``.  ``mesh_shape`` is an axis→size dict over the
    process group's ranks, e.g. ``{"data": 2}`` or ``{"data": -1,
    "model": 2}``.  A live context is returned as it is; asking it for
    another device raises."""
    global _context
    if _context is not None:
        if device is not None and \
                _resolve_device(device, _context.process_index) != \
                _context.device:
            raise ValueError(
                f"zoo context already lives on {_context.device}; "
                "reset_zoo_context() before switching devices")
        return _context

    import torch.distributed as dist
    n_proc = int(os.environ.get("ZOO_TPU_NUM_PROCESSES", "1"))
    coordinator = os.environ.get("ZOO_TPU_COORDINATOR")
    rank = int(os.environ.get("ZOO_TPU_PROCESS_ID", "0"))
    if dist.is_available() and dist.is_initialized():
        rank = dist.get_rank()
    dev = _resolve_device(device, rank if n_proc > 1 else 0)
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

    # multi-process bring-up (the reference's jax.distributed role): only
    # when the launcher's contract declares more than one process
    if n_proc > 1 and coordinator and not dist.is_initialized():
        init_process_group(coordinator, n_proc, rank, dev)

    from analytics_zoo_torch.parallel import mesh as mesh_lib
    if mesh_shape is None:
        mesh_shape = _mesh_shape_from_config(config)
    _context = ZooContext(config, dev, mesh_lib.create_mesh(mesh_shape))

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
