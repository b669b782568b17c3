"""CheckpointManager: asynchronous, atomic training checkpoints.

Counterpart of ``deeplearning4j_tpu/checkpoint/manager.py``, for one
process::

    mgr = CheckpointManager(dir, keep_last_n=3)
    state = capture_training_state(net, epoch=e)     # device->host copy
    mgr.save(step, state, metrics={"loss": l})       # returns at once
    ...
    mgr.wait_until_finished()                        # surfaces writer errors
    restored = mgr.restore_latest(model=net)         # skips torn dirs

The commit protocol of step N is the JAX package's:

1. stage everything under ``step_N.tmp/`` (payload files fsynced);
2. write ``MANIFEST.json`` (each file's size and sha256), then the
   ``COMMIT`` marker, and fsync both;
3. ``os.replace(step_N.tmp, step_N)`` and fsync the directory: the
   atomic publish. A crash at any earlier point leaves a ``.tmp``
   directory (or a final directory failing verification), which restore
   skips and ``gc_uncommitted()`` removes.

The writer thread serializes, hashes and fsyncs, so ``fit`` waits only
for ``capture_training_state``'s device-to-host copy. Writer errors are
sticky: they raise again at the next ``save()`` or
``wait_until_finished()``. ``records`` keeps each commit's figures (the
JAX package's ``{"type": "checkpoint"}`` record: bytes, serialize,
commit and queue seconds).

For one process the JAX shard topology reduces to one shard: a committed
step written by several processes raises ``ShardCountMismatchError``
(its resharded restore, ``checkpoint/reshard.py``, is not ported). No
fingerprint stamps are written or verified (``integrity/``): no step is
"verified", and ``restore_latest(verified_only=True)`` falls back, as
the JAX manager does when no stamp verifies, to the newest intact step.
``stats_storage=``, the ``{"type": "checkpoint"}`` records' sink, waits
for ``ui/``. Each is ROADMAP queue 1 item 7.
"""
from __future__ import annotations

import json
import os
import queue
import re
import shutil
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.checkpoint import manifest as _manifest
from deeplearning4j_tpu_torch.checkpoint.atomic import fsync_dir
from deeplearning4j_tpu_torch.checkpoint.state import (
    TrainingState, capture_training_state, read_state_files,
    restore_training_state, write_state_files)
from deeplearning4j_tpu_torch.monitor.trace import TRACER as _tracer

_STEP_RE = re.compile(r"^step_(\d+)$")
# .tmp = staging dir from a killed writer; .old = a committed dir swapped
# aside during a re-save whose cleanup was interrupted
_TMP_RE = re.compile(r"^step_(\d+)\.(tmp|old)$")


class CheckpointError(RuntimeError):
    """An asynchronous checkpoint write failed (raised on the training
    thread at the next save() or wait_until_finished())."""


class TopologyChangedError(CheckpointError):
    """The topology at restore differs from the checkpoint's."""

    def __init__(self, message: str, *, step: Optional[int] = None,
                 manifest: Optional[Dict[str, Any]] = None,
                 runtime: Optional[Dict[str, Any]] = None):
        super().__init__(message)
        self.step = step
        self.manifest = dict(manifest or {})
        self.runtime = dict(runtime or {})


class ShardCountMismatchError(TopologyChangedError):
    """A committed checkpoint was written by ``manifest_count``
    processes; this runtime is one."""

    def __init__(self, step: int, manifest_count: int, runtime_count: int,
                 detail: str = ""):
        self.manifest_count = int(manifest_count)
        self.runtime_count = int(runtime_count)
        super().__init__(
            f"checkpoint step {step} was committed by {manifest_count} "
            f"process(es) but this runtime has {runtime_count}"
            f"{': ' + detail if detail else ''}; the resharded restore is "
            f"not ported yet (ROADMAP queue 1 item 7: checkpoint/"
            f"reshard.py)",
            step=int(step),
            manifest={"process_count": int(manifest_count)},
            runtime={"process_count": int(runtime_count)})


class CheckpointManager:
    """Atomic, retained, optionally asynchronous checkpoint directory.

    Retention, applied after every commit (pinned steps always kept):
    ``keep_last_n`` newest checkpoints; ``keep_every_n_epochs``: those
    whose epoch is a multiple of N, kept for good; ``pin_best_metric``:
    the checkpoint with the best ``metrics[name]`` (``pin_best_mode``
    'min' or 'max')."""

    def __init__(self, directory, keep_last_n: Optional[int] = 3,
                 keep_every_n_epochs: Optional[int] = None,
                 pin_best_metric: Optional[str] = None,
                 pin_best_mode: str = "min",
                 async_write: bool = True,
                 stats_storage=None,
                 verify_memo_ttl_s: float = 300.0):
        if stats_storage is not None:
            raise NotImplementedError(
                "CheckpointManager(stats_storage=...) is not ported yet "
                "(ROADMAP queue 1 item 7: ui/); the commit records are in "
                "CheckpointManager.records")
        self.directory = os.fspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep_last_n = keep_last_n
        self.keep_every_n_epochs = keep_every_n_epochs
        self.pin_best_metric = pin_best_metric
        if pin_best_mode not in ("min", "max"):
            raise ValueError(f"pin_best_mode must be 'min'/'max', "
                             f"got {pin_best_mode!r}")
        self.pin_best_mode = pin_best_mode
        self.async_write = async_write
        self.process_index, self.process_count = 0, 1
        #: one dict per commit: step, bytes, serialize/commit/queue seconds
        self.records: List[Dict[str, Any]] = []
        self._pinned: set = set()
        # path -> (dir_token, verified_at): repeated rollbacks do not
        # re-hash unchanged committed files; entries expire after the
        # TTL, since media rot leaves the token unchanged
        self._verify_memo_ttl_s = float(verify_memo_ttl_s)
        self._verified_memo: Dict[str, tuple] = {}
        self._recover_aside()
        self._q: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._inflight = 0
        self._cv = threading.Condition(threading.RLock())
        self._commit_lock = threading.RLock()
        self._closed = False

    # ------------------------------------------------------------------
    # paths / listing
    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step):08d}")

    def _tmp_dir(self, step: int) -> str:
        return self.step_dir(step) + ".tmp"

    def _verify_full(self, d: str) -> List[str]:
        """Full verification of one step directory, memoized while its
        files' (mtime, size) are unchanged and the TTL holds."""
        token = _manifest.dir_token(d)
        ent = self._verified_memo.get(d)
        if token is not None and ent is not None and ent[0] == token \
                and time.monotonic() - ent[1] <= self._verify_memo_ttl_s:
            return []
        problems = _manifest.verify_dir(d, full=True)
        if problems or token is None:
            self._verified_memo.pop(d, None)
        else:
            self._verified_memo[d] = (token, time.monotonic())
        return problems

    def all_steps(self, verify: bool = False) -> List[int]:
        """Committed step numbers, ascending. ``verify=True`` re-hashes
        every file (memoized); the default checks the marker, manifest
        and sizes."""
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if not m:
                continue
            d = os.path.join(self.directory, name)
            ok = not self._verify_full(d) if verify \
                else _manifest.is_committed(d, full=False)
            if ok:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _recover_aside(self) -> None:
        """Repair a crash between a re-save's two renames: ``step_N`` is
        gone but ``step_N.old`` or a fully staged ``step_N.tmp`` still
        verifies, so it is renamed back."""
        for name in sorted(os.listdir(self.directory)):
            m = _TMP_RE.match(name)
            if not m:
                continue
            final = self.step_dir(int(m.group(1)))
            if os.path.isdir(final):
                continue
            d = os.path.join(self.directory, name)
            if not self._verify_full(d):
                os.replace(d, final)
                self._verified_memo.pop(d, None)
                fsync_dir(self.directory)

    def uncommitted_dirs(self) -> List[str]:
        """Torn or stale directories: ``.tmp`` leftovers and final
        directories failing full verification."""
        self._recover_aside()
        bad = []
        for name in sorted(os.listdir(self.directory)):
            d = os.path.join(self.directory, name)
            if _TMP_RE.match(name):
                bad.append(d)
            elif _STEP_RE.match(name) and self._verify_full(d):
                bad.append(d)
        return bad

    def gc_uncommitted(self) -> List[str]:
        """Delete torn or uncommitted directories."""
        removed = []
        for d in self.uncommitted_dirs():
            shutil.rmtree(d, ignore_errors=True)
            removed.append(d)
        return removed

    # ------------------------------------------------------------------
    # save
    def save(self, step: int, state: Optional[TrainingState] = None,
             model=None, epoch: int = 0,
             metrics: Optional[Dict[str, float]] = None,
             normalizer=None, blocking: bool = False, pin: bool = False,
             lock_timeout: Optional[float] = None) -> None:
        """Checkpoint ``step``: a captured ``state``, or one captured
        here from ``model`` (the device-to-host copy on the caller's
        thread; the rest is asynchronous unless ``blocking`` or
        ``async_write=False``). Raises any pending writer error first."""
        self.check_error()
        if self._closed:
            raise CheckpointError("CheckpointManager is closed")
        if state is None:
            if model is None:
                raise ValueError("save() needs state= or model=")
            with _tracer.span("checkpoint.capture", cat="checkpoint",
                              step=int(step)):
                state = capture_training_state(model, epoch=epoch,
                                               normalizer=normalizer)
        if metrics:
            state.metadata.setdefault("metrics", {}).update(
                {k: float(v) for k, v in metrics.items()})
        if pin:
            self._pinned.add(int(step))
        enq_t = time.perf_counter()
        if blocking or not self.async_write:
            self._commit(int(step), state, enq_t, was_async=False,
                         lock_timeout=lock_timeout)
            return
        with self._cv:
            self._inflight += 1
        self._ensure_worker()
        self._q.put((int(step), state, enq_t))

    def _ensure_worker(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._drain, daemon=True,
                                            name="checkpoint-writer")
            self._worker.start()

    def _drain(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            step, state, enq_t = item
            try:
                self._commit(step, state, enq_t, was_async=True)
            except BaseException as e:   # sticky: surfaces on next save()
                self._error = e
            finally:
                with self._cv:
                    self._inflight -= 1
                    self._cv.notify_all()

    def _commit(self, step: int, state: TrainingState, enq_t: float,
                was_async: bool,
                lock_timeout: Optional[float] = None) -> None:
        if not self._commit_lock.acquire(
                timeout=-1 if lock_timeout is None else lock_timeout):
            raise CheckpointError(
                f"commit lock not acquired within {lock_timeout}s: "
                f"another commit is stuck")
        commit_span = _tracer.span(
            "checkpoint.commit", cat="checkpoint", step=int(step),
            asynchronous=bool(was_async))
        commit_span.__enter__()
        try:
            t0 = time.perf_counter()
            tmp = self._tmp_dir(step)
            final = self.step_dir(step)
            if os.path.isdir(tmp):
                shutil.rmtree(tmp)             # crash leftover
            os.makedirs(tmp)
            with _tracer.span("checkpoint.serialize", cat="checkpoint",
                              step=int(step)):
                write_state_files(tmp, state)
            t_serialize = time.perf_counter() - t0
            _manifest.write_manifest(tmp)
            _manifest.write_commit_marker(tmp)
            fsync_dir(tmp)
            # a re-save keeps the committed directory until the
            # replacement is fully staged: swapped aside only across the
            # two renames
            aside = None
            if os.path.isdir(final):
                aside = final + ".old"
                if os.path.isdir(aside):
                    shutil.rmtree(aside)
                os.replace(final, aside)
            os.replace(tmp, final)
            fsync_dir(self.directory)
            if aside is not None:
                shutil.rmtree(aside, ignore_errors=True)
            self._apply_retention()
            self.records.append({
                "type": "checkpoint", "step": int(step),
                "epoch": int(state.epoch),
                "iteration": int(state.iteration),
                "bytes": int(state.nbytes()),
                "serialize_seconds": t_serialize,
                "commit_seconds": time.perf_counter() - t0,
                "queue_seconds": max(0.0, t0 - enq_t),
                "async": bool(was_async), "t": time.time()})
        finally:
            commit_span.__exit__(*sys.exc_info())
            self._commit_lock.release()

    # ------------------------------------------------------------------
    # completion / errors
    def wait_until_finished(self, timeout: Optional[float] = None) -> None:
        """Block until every queued save has committed; raise the first
        writer error if one occurred."""
        with self._cv:
            if not self._cv.wait_for(lambda: self._inflight == 0,
                                     timeout=timeout):
                raise CheckpointError(
                    f"{self._inflight} checkpoint write(s) still pending "
                    f"after {timeout}s")
        self.check_error()

    def check_error(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise CheckpointError(
                f"asynchronous checkpoint write failed: {err}") from err

    def close(self) -> None:
        """Drain pending writes and stop the writer thread."""
        if self._closed:
            return
        try:
            self.wait_until_finished()
        finally:
            self._closed = True
            if self._worker is not None and self._worker.is_alive():
                self._q.put(None)
                self._worker.join(timeout=10)

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    # restore
    def _check_shard_topology(self, step: int) -> None:
        count = int(self._step_meta(step).get("shard_count", 1))
        if count != self.process_count:
            raise ShardCountMismatchError(step, count, self.process_count)

    def restore(self, step: int, model=None,
                strict: bool = True) -> TrainingState:
        """Load and verify step ``step``, and restore it into ``model``
        if one is given. Raises ``CheckpointError`` where the step is
        missing or fails verification."""
        d = self.step_dir(step)
        problems = self._verify_full(d)
        if problems:
            raise CheckpointError(
                f"checkpoint step {step} at {d} is not committed/intact: "
                f"{problems}")
        self._check_shard_topology(step)
        try:
            state = read_state_files(d)
        except FileNotFoundError as e:
            raise CheckpointError(
                f"checkpoint step {step} lost files after verification "
                f"({e})") from e
        if model is not None:
            restore_training_state(model, state, strict=strict)
        return state

    def latest_verified_step(self) -> Optional[int]:
        """The newest committed step whose fingerprint stamp verifies:
        None, since no stamp is written or checked until ``integrity/``
        is ported (ROADMAP queue 1 item 7)."""
        return None

    def restore_latest(self, model=None, strict: bool = True,
                       verified_only: bool = False
                       ) -> Optional[Tuple[int, TrainingState]]:
        """Restore the newest committed checkpoint, skipping torn,
        uncommitted or corrupted directories (a missing COMMIT, a bad
        manifest, truncated or bit-flipped payloads). Returns ``(step,
        state)``, or None when nothing is restorable. ``verified_only``
        falls back to the newest intact step, since no step is verified
        (:meth:`latest_verified_step`)."""
        self._recover_aside()
        candidates = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m:
                candidates.append(int(m.group(1)))
        for step in sorted(candidates, reverse=True):
            d = self.step_dir(step)
            if self._verify_full(d):
                continue                       # torn or corrupt: skip
            self._check_shard_topology(step)
            try:
                state = read_state_files(d)
            except FileNotFoundError as e:
                raise CheckpointError(
                    f"checkpoint step {step} lost files after "
                    f"verification ({e})") from e
            if model is not None:
                restore_training_state(model, state, strict=strict)
            return step, state
        return None

    # ------------------------------------------------------------------
    # retention
    def pin(self, step: int) -> None:
        """Exempt ``step`` from retention for good."""
        self._pinned.add(int(step))

    def unpin(self, step: int) -> None:
        self._pinned.discard(int(step))

    def _step_meta(self, step: int) -> Dict[str, Any]:
        try:
            with open(os.path.join(self.step_dir(step), "state.json"),
                      encoding="utf-8") as fh:
                return json.load(fh)
        except (OSError, ValueError):
            return {}

    def _apply_retention(self) -> None:
        steps = self.all_steps()
        if not steps:
            return
        keep = set(self._pinned)
        metas = {s: self._step_meta(s) for s in steps}
        if self.keep_every_n_epochs:
            n = int(self.keep_every_n_epochs)
            keep.update(s for s, m in metas.items()
                        if int(m.get("epoch", 0)) % n == 0)
        if self.pin_best_metric:
            best = self._best(metas)
            if best is not None:
                keep.add(best)
        if self.keep_last_n is not None:
            rest = [s for s in steps if s not in keep]
            keep.update(rest[-int(self.keep_last_n):])
        else:
            keep.update(steps)
        for s in steps:
            if s not in keep:
                shutil.rmtree(self.step_dir(s), ignore_errors=True)

    def _best(self, metas: Dict[int, Dict[str, Any]]) -> Optional[int]:
        scored = [(s, m.get("metadata", {}).get("metrics", {})
                   .get(self.pin_best_metric)) for s, m in metas.items()]
        scored = [(s, v) for s, v in scored if v is not None]
        if not scored:
            return None
        pick = min if self.pin_best_mode == "min" else max
        return pick(scored, key=lambda sv: sv[1])[0]

    def best_step(self) -> Optional[int]:
        """The committed step with the best pinned metric (or None)."""
        if not self.pin_best_metric:
            return None
        return self._best({s: self._step_meta(s) for s in self.all_steps()})
