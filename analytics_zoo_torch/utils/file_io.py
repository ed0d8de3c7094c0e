"""File IO across local and remote filesystems (port of the JAX
package's ``utils/file_io.py``).

Reference: the HDFS/S3 helpers threaded through
zoo/common/Utils.scala and zoo/pipeline/api/net/utils/File.scala
(``getFileSystem``, ``saveBytes``/``readBytes`` with
``hdfs://``/``s3://`` URIs) — every loader/saver in the reference
accepts remote paths.

Local paths use plain ``os``/``glob``; remote schemes (``gs://``,
``s3://``, ``hdfs://``, ...) route through fsspec, imported only when a
remote path is used, with an error naming the missing backend package
when one isn't installed.  A local read fills a ``bytearray``, so the
checkpoint decoder can view it without a copy.
"""

from __future__ import annotations

import glob as _glob
import os
from typing import List

_REMOTE_SCHEMES = ("gs://", "s3://", "s3a://", "hdfs://", "abfs://",
                   "http://", "https://")


def is_remote(path: str) -> bool:
    return str(path).startswith(_REMOTE_SCHEMES)


def _fs(path: str):
    try:
        import fsspec
    except ImportError as e:             # pragma: no cover
        raise ImportError(
            f"remote path {path!r} needs fsspec (pip install fsspec "
            "plus the scheme backend, e.g. gcsfs/s3fs)") from e
    try:
        fs, _ = fsspec.core.url_to_fs(path)
        return fs
    except ImportError as e:
        raise ImportError(
            f"no fsspec backend for {path!r}: {e} — install the "
            "scheme's package (gcsfs for gs://, s3fs for s3://, "
            "pyarrow for hdfs://)") from e


def open_file(path: str, mode: str = "rb"):
    """Open local or remote path; caller closes (context manager)."""
    if is_remote(path):
        return _fs(path).open(path, mode)
    if "w" in mode:
        os.makedirs(os.path.dirname(os.path.abspath(path)),
                    exist_ok=True)
    return open(path, mode)


def read_bytes(path: str) -> bytearray:
    """The whole file.  A local file is read into one ``bytearray`` of
    its size; a file that ends early raises ``EOFError``."""
    if is_remote(path):
        with open_file(path, "rb") as f:
            return bytearray(f.read())
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        buf = bytearray(size)
        got = f.readinto(buf)
    if got != size:
        raise EOFError(f"{path}: read {got} of {size} bytes")
    return buf


def write_bytes(path: str, data: bytes) -> None:
    with open_file(path, "wb") as f:
        f.write(data)


def exists(path: str) -> bool:
    if is_remote(path):
        return _fs(path).exists(path)
    return os.path.exists(path)


def list_files(pattern: str) -> List[str]:
    """Glob local or remote; remote results keep their scheme."""
    if is_remote(pattern):
        fs = _fs(pattern)
        return sorted(fs.unstrip_protocol(p) if "://" not in str(p)
                      else str(p) for p in fs.glob(pattern))
    return sorted(_glob.glob(pattern))


def makedirs(path: str) -> None:
    if is_remote(path):
        _fs(path).makedirs(path, exist_ok=True)
    else:
        os.makedirs(path, exist_ok=True)
