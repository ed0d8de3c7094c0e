"""Small filesystem helpers shared by the jax-free control-plane
modules (supervisor, heartbeats, serving port discovery)."""

from __future__ import annotations

import os


def atomic_write_text(path: str, text: str) -> None:
    """Write ``text`` to ``path`` atomically (pid-unique tmp +
    ``os.replace``): a reader never sees a torn file, and two
    processes racing on the same path on a shared filesystem cannot
    interleave into one tmp file or rename a partially-written one.
    OSError propagates — callers own their degrade/log policy."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Bytes twin of :func:`atomic_write_text` — same pid-unique tmp +
    ``os.replace`` contract for binary payloads (pickles, npz blobs).
    OSError propagates — callers own their degrade/log policy."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
