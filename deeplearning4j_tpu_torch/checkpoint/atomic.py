"""Crash-safe filesystem primitives.

Counterpart of ``deeplearning4j_tpu/checkpoint/atomic.py``, copied (host
code). The invariant every writer relies on: a reader never observes a
partially written file at its final path. The recipe: write a temp file
in the destination directory, flush and fsync it, ``os.replace`` it into
place, fsync the directory so that the rename itself is durable.
``os.replace`` is atomic on POSIX when source and target are on one
filesystem, which is why the temp file is made next to the target.
"""
from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
from typing import Callable, Iterator


def _umask_mode(base: int = 0o666) -> int:
    """The mode a plain open() would have produced under the current
    umask — mkstemp creates 0600, which must not silently narrow
    permissions on published artifacts (shared checkpoint dirs)."""
    cur = os.umask(0)
    os.umask(cur)
    return base & ~cur


def fsync_dir(path: str) -> None:
    """fsync a directory so a just-renamed/created entry survives a
    crash (no-op on platforms that cannot open directories)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:          # pragma: no cover - windows / exotic fs
        return
    try:
        os.fsync(fd)
    except OSError:          # pragma: no cover
        pass
    finally:
        os.close(fd)


@contextlib.contextmanager
def atomic_output_file(path, suffix: str = ".tmp") -> Iterator[str]:
    """Context manager yielding a temp path in ``path``'s directory; on
    clean exit the temp file is fsynced and atomically renamed to
    ``path``. On error the temp file is removed and nothing is visible
    at ``path``::

        with atomic_output_file(dst) as tmp:
            write_everything_to(tmp)
        # dst now exists, complete, or was never touched
    """
    path = os.fspath(path)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".",
                               suffix=suffix)
    os.close(fd)
    try:
        yield tmp
        # the writer may have replaced (not appended to) the temp file;
        # open it ourselves to fsync whatever is there now
        with open(tmp, "rb") as fh:
            os.fsync(fh.fileno())
        os.chmod(tmp, _umask_mode())     # mkstemp's 0600 -> umask mode
        os.replace(tmp, path)
        fsync_dir(d)
    except BaseException:
        with contextlib.suppress(OSError):
            os.remove(tmp)
        raise


def atomic_write_bytes(path, data: bytes) -> None:
    """Atomically publish ``data`` at ``path``."""
    with atomic_output_file(path) as tmp:
        with open(tmp, "wb") as fh:
            fh.write(data)


def atomic_write_via(path, write_fn: Callable[[str], None]) -> None:
    """Run ``write_fn(temp_path)`` and atomically publish the result at
    ``path``. The serializer must write to EXACTLY the path it is given
    (``model.save``, ``zipfile.ZipFile`` do); serializers that append
    their own extension (``np.savez`` adds ``.npz``) would leave the
    temp file untouched and publish an empty artifact — pass a wrapper
    that renames, or use ``atomic_write_bytes``."""
    with atomic_output_file(path) as tmp:
        write_fn(tmp)


def atomic_copy(src_path, dst_path) -> str:
    """Copy ``src_path`` to ``dst_path`` so the destination appears
    atomically (temp copy in the destination directory + rename)."""
    with atomic_output_file(dst_path) as tmp:
        shutil.copy2(src_path, tmp)
    return os.fspath(dst_path)
