"""The fit tiers: per-step, fused windows and the scanned epoch.

Counterpart of ``deeplearning4j_tpu/autodiff/window.py`` (``pow2_buckets``
:57, ``fit_windowed`` :237) and of the tier choice and the per-step and
scanned tiers of ``SameDiff.fit`` (``samediff.py`` :1558, :1619-1636,
``_fit_scanned`` :1935). A small model's step is set by the host's
launches, not by the device (the JAX module's :1-8); the JAX package
therefore scans K steps into one compiled dispatch, and the port captures
K steps into one CUDA graph (:class:`StepWindow`) and replays it:

- **scanned epoch**: no listeners, an iterator with ``stacked_batches``
  (``DeviceCachedIterator``) and ``fused_steps <= 1``. One window of all
  the epoch's steps, reading the iterator's tensors in place: one replay
  an epoch.
- **fused windows**: ``fused_steps = K > 1``. Windows of K steps over
  static ``(K, batch, ...)`` input buffers, filled before each replay (a
  device copy from ``stacked_batches``, or one pinned host-to-device copy
  of K host batches). A ragged tail of r < K steps runs as
  ``pow2_buckets(r)`` windows, so at most log2(K)+1 window lengths are
  ever captured; a batch of another shape than the first (a ragged final
  batch) runs as one eager step.
- **per-step**: one eager step a batch.

Every tier runs the same train step and the same update kernels. The
tiers serve any :class:`StepOwner`, the small protocol of what owns a
train step: ``SameDiff`` (and ``MultiLayerNetwork`` through it) and
``ComputationGraph``. What changes from step to step, the updater's
scalars (Adam's ``alphat``), is computed on the host in float32 for the
K steps of a window and copied into the window's ``(K,)`` buffer before
each replay. Losses stay on the device: without listeners they are
fetched once at the end of the fit; with listeners once every
``min(frequency)`` steps, at the first window boundary at or after it,
and delivered through ``Listener.iterations_done`` (on the per-step tier
every ``min(frequency)`` buffered steps, as the JAX one). The host counters
(``iteration_count``, ``epoch_count``) advance by a window's K steps.

On the CPU a window runs its K steps eagerly; on the card it is always a
graph, and an error of a capture or a replay propagates. A kernel
wrapper counts its launches when it is called; inside a capture that
call only records the launch, so a window takes what its recording added
to the counters back out and adds it again at each replay, when the
kernels run (the warm-up steps before a capture launch, and count, as
any eager step does).
"""
from __future__ import annotations

import gc
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.autodiff.training import History
from deeplearning4j_tpu_torch.kernels import _cuda
from deeplearning4j_tpu_torch.learning.updaters import stage_
from deeplearning4j_tpu_torch.ops import registry

Env = Dict[str, torch.Tensor]

#: warm-up steps before a capture (cuDNN's algorithm choice, autograd's
#: lazy set-up, the ``_foreach`` kernels); their updates are undone
WARMUP_STEPS = 2


def pow2_buckets(r: int) -> List[int]:
    """Binary decomposition of a ragged tail length into descending
    powers of two. ``pow2_buckets(13) == [8, 4, 1]``."""
    out = []
    b = 1
    while r > 0:
        if r & 1:
            out.append(b)
        r >>= 1
        b <<= 1
    return out[::-1]


def capturing() -> bool:
    """Whether the current stream is capturing a CUDA graph."""
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def refuse_random_ops(sd) -> None:
    """A captured window replays its random numbers: a graph with a
    random op is refused by name on the graph tiers."""
    for node in sd._prune(sd._resolve_loss()):
        if registry.get_op(node.op).category == "random":
            raise NotImplementedError(
                f"op {node.name!r} ({node.op}) draws random numbers, which "
                f"a CUDA graph would replay unchanged: the fused-window and "
                f"scanned tiers refuse it until dropout is ported (ROADMAP "
                f"queue 1 item 5); fit it with fused_steps=1 and a listener")


class StepOwner:
    """What owns a train step, for the fit tiers. An owner has
    ``device``, ``training_config`` (a ``TrainingConfig``: the updater,
    ``fused_steps``, the step and epoch counters, and the names its
    batches' features and labels take), ``last_fit_stats``, and:

    - ``_train_step(names, placeholders, state, scal)``: one step on the
      named batch ``placeholders`` (on the device, as
      ``_prep_placeholders`` gives them), updating the trainables
      ``names`` and their updater ``state`` in place with the step's
      scalar ``scal`` (a 0-d device tensor); returns the loss on the
      device. No host sync, no host-to-device copy: a window captures it.
    - ``_fit_state()``: ``(names, state)``, the updater state made once.
    - ``_prep_placeholders(batch)``: a named batch's arrays on the device,
      cast as the step takes them; ``_placeholder_dtype(name, value)``,
      the dtype it gives ``value``.
    - ``warmup_restore_set(names, state)``: every tensor a step writes in
      place (trainables, updater state, a module's buffers such as batch
      norm's running statistics), which a capture's warm-up steps save
      and restore.
    - ``_refuse_random_ops()``: raise where a step draws random numbers.

    This base keeps the captured windows (valid for one training config,
    updater and mixed-precision policy), their memory pool and capture
    stream, and the scanned tier's bound inputs. ``_changed()`` drops
    them: the owner calls it when a tensor a window reads by address is
    replaced."""

    last_fit_stats: Optional[Dict[str, object]] = None
    _windows: Dict[object, "StepWindow"]
    _windows_for: Optional[Tuple] = None
    _pool = None
    _stream: Optional["torch.cuda.Stream"] = None
    #: the scanned tier's inputs (:func:`_bound_inputs`)
    _bound: Optional[Tuple] = None

    def _changed(self) -> None:
        """A stored tensor's address, the graph or the updater state
        changed: the captured windows and the bound inputs are dropped."""
        self._windows = {}
        self._windows_for = None
        self._bound = None

    def _window_cache(self) -> Dict[object, "StepWindow"]:
        """The captured fit windows, for this training config."""
        tc = self.training_config
        owner = (tc, tc.updater, tc.mixed_precision)
        if self._windows_for is None or any(
                a is not b for a, b in zip(self._windows_for, owner)):
            self._windows = {}
            self._windows_for = owner
        return self._windows

    def _graph_pool(self):
        """One memory pool for all of this owner's captured windows."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def _capture_stream(self) -> "torch.cuda.Stream":
        """The side stream the windows warm up and are captured on."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream


class StepWindow:
    """K train steps of the owner ``sd`` over ``inputs`` (placeholder ->
    a ``(K, batch, ...)`` tensor whose address stays fixed), with
    ``scal``, a ``(K,)`` buffer of the updater's per-step scalars, and
    ``losses``, a ``(K,)`` buffer of the steps' losses. On the card the
    steps are captured once as a CUDA graph in the owner's pool, after
    warm-up steps whose writes (``warmup_restore_set``) are undone, and
    :meth:`run` replays it; on the CPU :meth:`run` runs them eagerly."""

    def __init__(self, sd: StepOwner, names: List[str], state, inputs: Env,
                 k: int):
        self.sd, self.names, self.state, self.inputs, self.k = \
            sd, names, state, inputs, k
        self.scal = torch.zeros(k, dtype=torch.float32, device=sd.device)
        self.losses = torch.zeros(k, dtype=torch.float32, device=sd.device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        #: what one replay adds to the kernel wrappers' counters
        self.counts: _cuda.Counts = []
        if sd.device.type == "cuda":
            self._capture()

    def _step(self, i: int) -> None:
        ph = {n: t[i] for n, t in self.inputs.items()}
        self.losses[i].copy_(self.sd._train_step(self.names, ph, self.state,
                                                 self.scal[i]))

    def _capture(self) -> None:
        sd = self.sd
        stream = sd._capture_stream()
        live = sd.warmup_restore_set(self.names, self.state)
        saved = [t.detach().clone() for t in live]
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            for i in range(WARMUP_STEPS):
                self._step(min(i, self.k - 1))
            with torch.no_grad():
                for t, s in zip(live, saved):
                    t.copy_(s)
        torch.cuda.current_stream().wait_stream(stream)
        del saved
        graph = torch.cuda.CUDAGraph()
        before = _cuda.count_snapshot()
        # An old graph that the cyclic collector frees while this one
        # captures destroys its executable, which CUDA refuses during
        # a capture, and that invalidates the capture (PyTorch's graph
        # context no longer collects first): collect now, none during it.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=sd._graph_pool(),
                                  stream=stream):
                for i in range(self.k):
                    self._step(i)
        finally:
            if collecting:
                gc.enable()
        self.counts = _cuda.counts_since(before)
        _cuda.add_counts(self.counts, -1)        # recorded, not launched
        self.graph = graph

    def run(self) -> None:
        if self.graph is not None:
            self.graph.replay()
            _cuda.add_counts(self.counts)
        else:
            for i in range(self.k):
                self._step(i)


def _name_batch(tc, batch) -> Dict[str, object]:
    from deeplearning4j_tpu_torch.autodiff.samediff import _split_batch
    feats, labels = _split_batch(batch)
    return {**dict(zip(tc.data_set_feature_mapping, feats)),
            **dict(zip(tc.data_set_label_mapping, labels))}


def _signature(ph: Dict[str, object]) -> Tuple:
    return tuple((n, tuple(np.shape(v))) for n, v in ph.items())


def _bound_inputs(sd, src: Dict[str, torch.Tensor]) -> Env:
    """The iterator's stacked tensors ``src`` as the owner's steps take
    them (``sd._prep_placeholders``: their dtypes, ``sd``'s device). A
    tensor that is so already is used in place. A cast copy is kept on
    ``sd`` with the source tensors (held, so no other tensor takes their
    addresses) and refreshed in place by each fit over them: the scanned
    window bound to it stays valid from fit to fit instead of being
    captured again."""
    key = tuple((n, t.data_ptr(), tuple(t.shape), t.stride(), t.dtype,
                 t.device) for n, t in src.items())
    if sd._bound is not None and sd._bound[0] == key:
        prepared = sd._bound[2]
        for n, t in src.items():
            if prepared[n] is not t:
                prepared[n].copy_(t)
        return prepared
    prepared = sd._prep_placeholders(src)
    sd._bound = (key, src, prepared)
    return prepared


class _Fit:
    """One ``fit``: the tier's units of work, counters, losses and
    listener deliveries."""

    def __init__(self, sd, iterator, listeners):
        self.sd, self.iterator, self.listeners = sd, iterator, listeners
        self.tc = tc = sd.training_config
        self.K = max(1, int(tc.fused_steps))
        if not listeners and hasattr(iterator, "stacked_batches") and \
                self.K <= 1:
            self.tier = "scanned_epoch"
        elif self.K > 1:
            self.tier = "windowed"
        else:
            self.tier = "per_step"
        if self.tier != "per_step":
            sd._refuse_random_ops()
        self.names, self.state = sd._fit_state()
        self.stacked = None
        if self.tier != "per_step" and hasattr(iterator, "stacked_batches"):
            feats, labels = iterator.stacked_batches()
            self.stacked = _bound_inputs(sd, {
                **dict(zip(tc.data_set_feature_mapping, feats)),
                **dict(zip(tc.data_set_label_mapping, labels))})
        self.flush_every = min((max(1, int(getattr(l, "frequency", 10)))
                                for l in listeners), default=0)
        self.next_flush = self._after(tc.iteration_count)
        self.pending: List[Tuple[int, torch.Tensor]] = []
        self.captures = 0
        #: the per-step tier's scalar, staged before each eager step
        self.scal = torch.zeros(1, dtype=torch.float32, device=sd.device)

    def _after(self, iteration: int) -> int:
        f = self.flush_every
        return (iteration // f + 1) * f if f else 0

    # -- units of work ---------------------------------------------------
    def _window(self, k: int, inputs: Optional[Env] = None,
                sig: Optional[Tuple] = None) -> StepWindow:
        """The cached window of ``k`` steps over ``inputs`` (bound in
        place), or over static buffers shaped like one batch ``sig``."""
        sd = self.sd
        if inputs is not None:
            key = ("in_place", k, tuple(
                (n, tuple(t.shape), t.stride(), t.dtype, t.data_ptr())
                for n, t in inputs.items()))
        else:
            key = ("buffers", k, sig)
        wins = sd._window_cache()
        win = wins.get(key)
        if win is None:
            if inputs is None:
                inputs = {n: torch.zeros((k, *shape), dtype=dt,
                                         device=sd.device)
                          for n, shape, dt in sig}
            else:
                # one in-place window at a time: it holds its inputs alive
                for old in [w for w in wins if w[0] == "in_place"]:
                    del wins[old]
            win = StepWindow(sd, self.names, self.state, inputs, k)
            wins[key] = win
            self.captures += 1
        return win

    def _units(self):
        """Yield, in data order, ``(window, fill)`` for a window (``fill``
        copies its inputs into its buffers, or is None) and
        ``(None, placeholders)`` for one eager step."""
        sd, tc = self.sd, self.tc
        if self.tier == "scanned_epoch":
            n = next(iter(self.stacked.values())).shape[0]
            yield self._window(n, inputs=self.stacked), None
            return
        if self.tier == "per_step":
            if hasattr(self.iterator, "reset"):
                self.iterator.reset()
            for batch in self.iterator:
                yield None, sd._prep_placeholders(_name_batch(tc, batch))
            return
        if self.stacked is not None:
            n = next(iter(self.stacked.values())).shape[0]
            parts, j = [], 0
            while n - j >= self.K:
                parts.append((j, self.K))
                j += self.K
            for k in pow2_buckets(n - j):
                parts.append((j, k))
                j += k
            for j, k in parts:
                src = {nm: t[j:j + k] for nm, t in self.stacked.items()}
                sig = tuple((nm, tuple(t.shape[1:]), t.dtype)
                            for nm, t in src.items())
                win = self._window(k, sig=sig)

                def fill(w=win, src=src):
                    for nm, t in src.items():
                        w.inputs[nm].copy_(t)
                yield win, fill
            return
        yield from self._host_windows()

    def _host_windows(self):
        sd, tc = self.sd, self.tc
        if hasattr(self.iterator, "reset"):
            self.iterator.reset()
        buf: List[Dict[str, object]] = []
        first = None

        def windows(batches):
            i = 0
            for k in pow2_buckets(len(batches)) if len(batches) < self.K \
                    else [self.K]:
                part = batches[i:i + k]
                i += k
                sig = tuple((nm, tuple(np.shape(v)),
                             sd._placeholder_dtype(nm, v))
                            for nm, v in part[0].items())
                win = self._window(k, sig=sig)

                def fill(w=win, part=part):
                    for nm, dst in w.inputs.items():
                        items = [b[nm] for b in part]
                        stage_(dst, np.stack(items) if all(
                            isinstance(a, np.ndarray) for a in items)
                            else torch.stack([torch.as_tensor(a)
                                              for a in items]))
                yield win, fill

        for batch in self.iterator:
            ph = _name_batch(tc, batch)
            sig = _signature(ph)
            if first is None:
                first = sig
            if sig != first:            # a ragged batch: one eager step
                yield from windows(buf)
                buf = []
                yield None, sd._prep_placeholders(ph)
                continue
            buf.append(ph)
            if len(buf) == self.K:
                yield from windows(buf)
                buf = []
        if buf:
            yield from windows(buf)

    # -- the loop --------------------------------------------------------
    def _flush(self, epoch: int, epoch_vals: List[float]) -> None:
        if not self.pending:
            return
        iters = [it for start, l in self.pending
                 for it in range(start, start + l.shape[0])]
        vals = torch.cat([l for _, l in self.pending]).tolist()
        self.pending.clear()
        epoch_vals.extend(vals)
        for l in self.listeners:
            l.iterations_done(self.sd, epoch, iters, vals)

    def run(self, epochs: int) -> History:
        sd, tc, listeners = self.sd, self.tc, self.listeners
        updater = tc.updater
        history = History()
        deferred: List[torch.Tensor] = []
        for l in listeners:
            l.on_training_start(sd)
        for epoch in range(epochs):
            start = tc.iteration_count
            epoch_vals: List[float] = []
            epoch_losses: List[torch.Tensor] = []
            sizes: Dict[int, int] = {}
            windows = eager = 0
            captures0 = self.captures
            for l in listeners:
                l.on_epoch_start(sd, epoch)
            for win, work in self._units():
                it = tc.iteration_count
                if win is None:
                    stage_(self.scal, updater.step_scalars(
                        [it], tc.epoch_count))
                    losses = sd._train_step(self.names, work, self.state,
                                            self.scal[0])[None]
                    eager += 1
                    k = 1
                else:
                    k = win.k
                    if work is not None:
                        work()
                    stage_(win.scal, updater.step_scalars(
                        range(it, it + k), tc.epoch_count))
                    win.run()
                    losses = win.losses.clone()
                    windows += 1
                sizes[k] = sizes.get(k, 0) + 1
                tc.iteration_count = it + k
                if listeners:
                    self.pending.append((it, losses))
                    # per-step: every flush_every buffered steps; windows:
                    # the first boundary at or after each multiple of it
                    due = len(self.pending) >= self.flush_every \
                        if self.tier == "per_step" \
                        else tc.iteration_count >= self.next_flush
                    if due:
                        self._flush(epoch, epoch_vals)
                        self.next_flush = self._after(tc.iteration_count)
                else:
                    epoch_losses.append(losses)
            if tc.iteration_count == start:
                raise ValueError("fit got no batches")
            if listeners:
                self._flush(epoch, epoch_vals)
                self.next_flush = self._after(tc.iteration_count)
                history.add_epoch(epoch, float(np.mean(epoch_vals)),
                                  epoch_vals)
            else:
                deferred.append(torch.cat(epoch_losses))
            tc.epoch_count += 1
            sd.last_fit_stats = {
                "tier": self.tier, "fused_steps": self.K,
                "steps_per_epoch": tc.iteration_count - start,
                "dispatches_per_epoch": windows + eager,
                "graph_replays_per_epoch":
                    windows if sd.device.type == "cuda" else 0,
                "eager_steps_per_epoch": eager,
                "window_sizes": sizes,
                "window_captures": self.captures - captures0}
            stop = False
            for l in listeners:
                mean = history.epoch_losses[-1] if history.epoch_losses \
                    else float("nan")
                if l.on_epoch_end(sd, epoch, mean) is False:
                    stop = True
            if stop:
                break
        if deferred:                     # one transfer for the fit
            flat = torch.cat(deferred).tolist()
            for e, t in enumerate(deferred):
                vals, flat = flat[:len(t)], flat[len(t):]
                history.add_epoch(e, float(np.mean(vals)), vals)
        for l in listeners:
            l.on_training_end(sd)
        return history


def fit(sd: StepOwner, iterator, epochs: int = 1, listeners=()) -> History:
    """The fit tiers of ``SameDiff.fit`` and ``ComputationGraph.fit``;
    see the module docstring."""
    return _Fit(sd, iterator, list(listeners)).run(epochs)
