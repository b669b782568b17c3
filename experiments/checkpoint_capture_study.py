"""How a training-state snapshot's device-to-host copy should be made, on
one card.

    python3 experiments/checkpoint_capture_study.py

``checkpoint.capture_training_state`` is the synchronous part of an
asynchronous checkpoint: the fit waits for it at a flush, while the
manager's writer thread serializes, hashes and fsyncs the snapshots
before it. This script times that copy for the state
``chip_smoke.py`` phase 26 checkpoints: ResNet-50 (224x224x3, 1000
classes) with its Nesterovs velocities: every parameter, running
statistic and velocity, about 205 MB of float32. Each method makes
8 snapshots, 0.45 s apart (8 steps of phase 26's windows), each handed
to a ``CheckpointManager`` writing in the background as the listener
hands it; the writer holds a snapshot until it has committed it. Methods:

- pinned_each: a pinned host tensor a tensor, the copies queued without
  waiting, one synchronize (``checkpoint/state.py``'s ``_host_copies``);
- pageable_each: ``tensor.to("cpu")`` a tensor (each copy waits);
- flat_pinned: the tensors of one dtype concatenated on the card, one
  copy into one pinned host buffer, numpy views of it;
- flat_pageable: the same concatenation, one ``.to("cpu")``.

Each runs beside the writer as ``checkpoint/state.py`` has it
(``file``: ``np.savez`` into the file) and, for pinned_each, beside the
JAX package's writer (``bytesio``: ``np.savez`` into a ``BytesIO``, whose
whole archive is then copied out and written), in alternating order.

Printed: each run's first capture and the median and maximum of the
others, in ms, host clock around the capture (``torch.cuda.synchronize()``
before it), and each commit's seconds, the card's name and power limit
beside them. Every snapshot is checked equal to the first one.
"""
import io
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from deeplearning4j_tpu_torch.checkpoint import CheckpointManager  # noqa
from deeplearning4j_tpu_torch.checkpoint import state as st  # noqa
from deeplearning4j_tpu_torch.environment import card_info  # noqa


def _tensors(net):
    live = st._live_arrays(net)
    leaves = st._live_leaves(net)
    return list(live), list(live.values()) + [t for _, t in leaves]


def pinned_each(ts):
    return st._host_copies(ts)


def pageable_each(ts):
    return [t.detach().to("cpu").numpy() for t in ts]


def _flat(ts, pinned):
    by_dtype = {}
    for i, t in enumerate(ts):
        by_dtype.setdefault(t.dtype, []).append(i)
    out = [None] * len(ts)
    for dtype, idx in by_dtype.items():
        flat = torch.cat([ts[i].detach().reshape(-1) for i in idx])
        if pinned:
            host = torch.empty(flat.shape, dtype=dtype, pin_memory=True)
            host.copy_(flat, non_blocking=True)
            torch.cuda.current_stream().synchronize()
        else:
            host = flat.to("cpu")
        arr, off = host.numpy(), 0
        for i in idx:
            n = ts[i].numel()
            out[i] = arr[off:off + n].reshape(tuple(ts[i].shape))
            off += n
    return out


def flat_pinned(ts):
    return _flat(ts, True)


def flat_pageable(ts):
    return _flat(ts, False)


def _bytesio_npz(path, arrays):
    """The JAX package's writer: the archive built in memory, then
    written."""
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    with open(path, "wb") as fh:
        fh.write(buf.getvalue())
        fh.flush()
        os.fsync(fh.fileno())


def main():
    if not torch.cuda.is_available():
        print("checkpoint_capture_study: no CUDA device", file=sys.stderr)
        return 1
    from deeplearning4j_tpu_torch.nn import ComputationGraph
    from deeplearning4j_tpu_torch.zoo import ResNet50
    card = card_info()
    net = ComputationGraph(ResNet50(height=224, width=224, channels=3,
                                    num_classes=1000).conf()).init("cuda")
    net._fit_state()
    with torch.no_grad():
        for s in net._updater_state:
            for t in s:
                t.normal_()
    names, ts = _tensors(net)
    nbytes = sum(t.numel() * t.element_size() for t in ts)
    print(f"{len(ts)} tensors, {nbytes} bytes  [{card}]", flush=True)
    ref = None
    tmp = tempfile.mkdtemp(prefix="capture_study_")
    try:
        file_npz = st._write_npz
        runs = [(pinned_each, "bytesio"), (pinned_each, "file"),
                (pageable_each, "file"), (flat_pinned, "file"),
                (flat_pageable, "file"), (pinned_each, "file"),
                (pinned_each, "bytesio")]
        for k, (method, writer) in enumerate(runs):
            st._write_npz = _bytesio_npz if writer == "bytesio" \
                else file_npz
            mgr = CheckpointManager(os.path.join(tmp, str(k)),
                                    keep_last_n=2)
            ms = []
            for i in range(8):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                host = method(ts)
                ms.append(1000 * (time.perf_counter() - t0))
                if ref is None:
                    ref = [a.copy() for a in host]
                elif not all(np.array_equal(a, b) for a, b in zip(host,
                                                                  ref)):
                    raise SystemExit(f"{method.__name__}: another snapshot")
                mgr.save(i, st.TrainingState(
                    arrays=dict(zip(names, host[:len(names)])),
                    updater_leaves=host[len(names):], iteration=i))
                time.sleep(0.45)
            mgr.close()
            print(f"{method.__name__:<14} {writer:<8} first {ms[0]:8.2f} "
                  f"ms, then "
                  f"median {np.median(ms[1:]):8.2f}, max {max(ms[1:]):8.2f}"
                  f" (all {[round(v, 1) for v in ms]}); commits s "
                  f"{[round(r['commit_seconds'], 3) for r in mgr.records]}"
                  f"  [{card}]", flush=True)
    finally:
        st._write_npz = file_npz
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
