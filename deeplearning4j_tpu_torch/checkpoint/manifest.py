"""Checkpoint-directory integrity: per-file sha256 manifest + COMMIT marker.

Counterpart of ``deeplearning4j_tpu/checkpoint/manifest.py``, copied
(host code; the same file names and format, so that either package
verifies the other's directories).

A checkpoint step directory is COMMITTED iff:

1. it is named ``step_<N>`` (no ``.tmp`` suffix — the writer builds the
   whole directory under ``step_<N>.tmp`` and ``os.replace``-renames it);
2. it contains ``MANIFEST.json`` listing every payload file with its
   size and sha256;
3. it contains the ``COMMIT`` marker (written after the manifest, fsynced
   before the rename);
4. every manifest entry verifies: the file exists, has the recorded
   size, and (in full verification) hashes to the recorded digest.

Anything else — a ``.tmp`` directory from a killed writer, a truncated
payload, a corrupted/absent manifest, a missing COMMIT — is an
UNCOMMITTED checkpoint: ``restore_latest()`` skips it and the manager
garbage-collects it.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional

MANIFEST_NAME = "MANIFEST.json"
COMMIT_NAME = "COMMIT"


def sha256_file(path, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for block in iter(lambda: fh.read(chunk), b""):
            h.update(block)
    return h.hexdigest()


def build_manifest(directory: str) -> Dict[str, dict]:
    """Hash every payload file in ``directory`` (manifest/marker
    excluded; one level — checkpoints are flat)."""
    entries: Dict[str, dict] = {}
    for name in sorted(os.listdir(directory)):
        if name in (MANIFEST_NAME, COMMIT_NAME):
            continue
        p = os.path.join(directory, name)
        if not os.path.isfile(p):
            continue
        entries[name] = {"size": os.path.getsize(p), "sha256": sha256_file(p)}
    return entries


def write_manifest(directory: str, entries: Optional[Dict[str, dict]] = None
                   ) -> Dict[str, dict]:
    if entries is None:
        entries = build_manifest(directory)
    data = json.dumps({"files": entries}, indent=1, sort_keys=True)
    path = os.path.join(directory, MANIFEST_NAME)
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    return entries


def write_commit_marker(directory: str) -> None:
    path = os.path.join(directory, COMMIT_NAME)
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("committed\n")
        fh.flush()
        os.fsync(fh.fileno())


def verify_dir(directory: str, full: bool = True) -> List[str]:
    """Return the list of integrity problems (empty = committed & intact).

    ``full=False`` checks structure + sizes only (cheap scan);
    ``full=True`` additionally re-hashes every payload file.
    """
    problems: List[str] = []
    if not os.path.isdir(directory):
        return [f"{directory}: not a directory"]
    if not os.path.isfile(os.path.join(directory, COMMIT_NAME)):
        problems.append("missing COMMIT marker")
    mpath = os.path.join(directory, MANIFEST_NAME)
    if not os.path.isfile(mpath):
        problems.append("missing MANIFEST.json")
        return problems
    try:
        with open(mpath, "r", encoding="utf-8") as fh:
            manifest = json.load(fh)
        files = manifest["files"]
    except (ValueError, KeyError, OSError) as e:
        problems.append(f"unreadable manifest: {e}")
        return problems
    for name, ent in files.items():
        p = os.path.join(directory, name)
        if not os.path.isfile(p):
            problems.append(f"{name}: missing")
            continue
        if os.path.getsize(p) != ent["size"]:
            problems.append(f"{name}: size {os.path.getsize(p)} != "
                            f"{ent['size']}")
            continue
        if full and sha256_file(p) != ent["sha256"]:
            problems.append(f"{name}: sha256 mismatch")
    return problems


def is_committed(directory: str, full: bool = True) -> bool:
    return not verify_dir(directory, full=full)


def dir_token(directory: str):
    """Cheap change token for a whole step directory: the sorted
    ``(name, mtime_ns, size)`` tuple of every file in it (one level —
    checkpoints are flat). Two equal tokens mean the files have not
    changed since the last full verification, so a repeat restore can
    skip the re-hash. Returns None when the directory is unreadable —
    never memoize that."""
    try:
        entries = []
        for name in sorted(os.listdir(directory)):
            p = os.path.join(directory, name)
            try:
                st = os.stat(p)
            except OSError:
                return None
            if os.path.isfile(p):
                entries.append((name, st.st_mtime_ns, st.st_size))
        return tuple(entries)
    except OSError:
        return None
