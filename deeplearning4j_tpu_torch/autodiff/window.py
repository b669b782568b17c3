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

Every tier runs the same train step (``autodiff/step.py``) and the same
update kernels. The tiers serve any :class:`StepOwner`, the small
protocol of what owns a train step: ``SameDiff`` (and
``MultiLayerNetwork`` through it) and ``ComputationGraph``. What changes
from step to step, the updater's scalar (Adam's ``alphat``) and the
learning rate (a schedule's value; weight decay scales by it), is
computed on the host in float32 for the K steps of a window and copied
into the window's ``(K, 2)`` buffer before each replay, with the steps'
absolute iterations into its ``(K,)`` buffer (read by the chaos
injection, the sentinel and the random ops). Each fit takes a new base
seed from the owner (JAX ``SameDiff.fit``), staged once into a device
tensor whose address the windows keep: a dropout mask is keyed by it, the
node and the step's iteration, all read on the device
(``kernels/dropout.py``), so a replayed window draws new masks each step.
As in the JAX fit, schedules are resolved
at epoch 0. Losses stay on the device: without listeners they are
fetched once at the end of the fit; with listeners once every
``min(frequency)`` steps, at the first window boundary at or after it,
and delivered through ``Listener.iterations_done`` (on the per-step tier
every ``min(frequency)`` buffered steps, as the JAX one). The host
counters (``iteration_count``, ``epoch_count``) advance by a window's K
steps.

Gradient accumulation (``accum_steps`` A > 1, JAX ``make_train_window``
:1146-1176) forces the fused-window tier, as in the JAX fit. A window's
apply positions, the steps at which ``(iteration + 1) % A == 0``, are
fixed by its first iteration modulo A (its phase), which is part of the
window's key: no window is captured again under training. The
accumulator is a device tensor a trainable, kept by the owner across
windows and fits, and zeroed at a fit's start when the iteration is a
multiple of A (a fit that ended mid-cycle leaves its partial sum for the
next). The updater sees ``iteration // A``.

The divergence sentinel (``sentinel``, JAX :1097-1106 and
``faults/sentinels.py``) folds each step's verdict into a device int64
of the window, the absolute iteration of its first bad step (-1 when
clean), read only where the fit already syncs: at a listener flush
(before the burst is delivered, so that no listener or checkpoint sees
a poisoned window) or, without listeners, at the epoch's end. The first
bad step raises ``TrainingDivergedError`` naming the step, the epoch and
the batch of the epoch, on every tier. The parameters are then already
poisoned, as the JAX fit's working copies are; roll back from a
checkpoint (``faults/recovery.py``).

Truncated BPTT (:func:`fit_tbptt`, the loop of JAX
``MultiLayerNetwork.fit_tbptt``, ``nn/multilayer.py:243-413``) is a tier
of its own over a graph whose recurrent states are state variables: for
each minibatch the states are zeroed in place (``zero_()`` on the
tensors the window reads), the ``T // L`` full chunks run as one window
(one replay on the card) whose steps carry the states in those tensors,
and a ragged tail chunk runs as one eager step.

On the CPU a window runs its K steps eagerly; on the card it is always a
graph, and an error of a capture or a replay propagates. A kernel
wrapper counts its launches when it is called; inside a capture that
call only records the launch, so a window takes what its recording added
to the counters back out and adds it again at each replay, when the
kernels run (the warm-up steps before a capture launch, and count, as
any eager step does).
"""
from __future__ import annotations

import contextlib
import gc
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.autodiff import step as steps
from deeplearning4j_tpu_torch.autodiff.training import History
from deeplearning4j_tpu_torch.kernels import _cuda
from deeplearning4j_tpu_torch.learning.updaters import stage_
from deeplearning4j_tpu_torch.ops import random as random_ops
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


def refuse_random_ops(sd) -> None:
    """A captured window replays its launches as recorded: a random op
    that does not draw from the device-staged seed and iteration (every
    one but ``ops/random.py``'s ``PORTED_RANDOM_OPS``) is refused by name
    on the graph tiers."""
    from deeplearning4j_tpu_torch.ops.random import PORTED_RANDOM_OPS
    for node in sd._prune(sd._resolve_loss()):
        o = registry.get_op(node.op)
        if o.category == "random" and o.name not in PORTED_RANDOM_OPS:
            raise NotImplementedError(
                f"op {node.name!r} ({node.op}) draws random numbers that a "
                f"CUDA graph would replay unchanged: the fused-window and "
                f"scanned tiers refuse it until it is ported (ROADMAP "
                f"queue 1 item 5; ops/random.py PORTED_RANDOM_OPS are); "
                f"fit it with fused_steps=1 and a listener")


class StepOwner:
    """What owns a train step, for the fit tiers. An owner has
    ``device``, ``training_config`` (a ``TrainingConfig``: the updater,
    the step's options, ``fused_steps``, ``accum_steps``, ``sentinel``,
    the step and epoch counters, and the names its batches' features and
    labels take), ``last_fit_stats``, and:

    - ``_grad_step(names, placeholders)``: the gradient half of one step
      on the named batch ``placeholders`` (on the device, as
      ``_prep_placeholders`` gives them): ``(loss, grads)``, the
      (unscaled) loss and the gradients of the trainables ``names``, on
      the device. No host sync, no host-to-device copy: a window
      captures it. ``autodiff/step.py`` runs the rest of the step.
    - ``_masters(names)``: the trainables' tensors, updated in place.
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
    stream, the scanned tier's bound inputs and the accumulator of
    ``accum_steps``. ``_changed()`` drops them: the owner calls it when
    a tensor a window reads by address is replaced. ``captures_total``
    counts the windows this owner ever captured."""

    last_fit_stats: Optional[Dict[str, object]] = None
    _windows: Dict[object, "StepWindow"]
    _windows_for: Optional[Tuple] = None
    _pool = None
    _stream: Optional["torch.cuda.Stream"] = None
    #: the scanned tier's inputs (:func:`_bound_inputs`)
    _bound: Optional[Tuple] = None
    #: ``accum_steps``' accumulator: (names, one tensor a trainable)
    _grad_accum: Optional[Tuple[List[str], List[torch.Tensor]]] = None
    captures_total: int = 0
    #: the next fit's base seed, and the one of the fit in flight (JAX
    #: ``SameDiff._seed`` / ``_fit_base_seed``): each fit takes a new one
    _seed: int = 0
    _fit_base_seed: Optional[int] = None
    #: the fit's base seed on the device, (1,) int64, its address fixed:
    #: staged at each fit's start, read by the step's random ops
    _rng_seed_buf: Optional[torch.Tensor] = None

    def rng_seed_tensor(self) -> torch.Tensor:
        """The device tensor the step's random ops read the base seed
        from (made once; not dropped by :meth:`_changed`)."""
        if self._rng_seed_buf is None:
            self._rng_seed_buf = torch.zeros(1, dtype=torch.int64,
                                             device=self.device)
        return self._rng_seed_buf

    def _take_seed(self) -> int:
        seed = self._seed
        self._seed += 1
        return seed

    def _begin_fit_seed(self) -> None:
        """A fit takes the next base seed (JAX ``SameDiff.fit``
        :1673-1678) and stages it for its steps."""
        self._fit_base_seed = self._take_seed()
        stage_(self.rng_seed_tensor(),
               np.array([self._fit_base_seed], np.int64))

    @contextlib.contextmanager
    def _call_rng(self, draws: bool = True):
        """A call outside a fit takes the next seed (JAX
        ``output``/``calculate_gradients``: ``key(self._seed)``, then
        ``_seed += 1``) and, if it ``draws``, runs its random ops with it
        at iteration 0."""
        seed = self._take_seed()
        if not draws:
            yield
            return
        with random_ops.rng_scope(*random_ops.host_rng(seed, 0,
                                                       self.device)):
            yield

    def _changed(self) -> None:
        """A stored tensor's address, the graph or the updater state
        changed: the captured windows, the bound inputs and the
        accumulator are dropped."""
        self._windows = {}
        self._windows_for = None
        self._bound = None
        self._grad_accum = None

    def _window_cache(self) -> Dict[object, "StepWindow"]:
        """The captured fit windows, for this training config."""
        tc = self.training_config
        owner = (tc, tc.updater, tc.mixed_precision)
        if self._windows_for is None or any(
                a is not b for a, b in zip(self._windows_for, owner)):
            self._windows = {}
            self._windows_for = owner
        return self._windows

    def _accumulator(self, names: List[str]) -> List[torch.Tensor]:
        """The accumulator of ``accum_steps``: zeros like each trainable,
        made once for a trainable set (the windows read it by
        address)."""
        if self._grad_accum is None or self._grad_accum[0] != names:
            # a window that read another accumulator was captured for
            # another trainable set, which dropped it (``_fit_state``)
            self._grad_accum = (list(names), [
                torch.zeros_like(m) for m in self._masters(names)])
        return self._grad_accum[1]

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


def apply_positions(start: int, k: int, accum_steps: int) -> List[bool]:
    """Whether the updater applies at each of the ``k`` steps from
    iteration ``start``: ``(iteration + 1) % accum_steps == 0``."""
    return [(start + i + 1) % accum_steps == 0 for i in range(k)]


def step_rows(updater, start: int, k: int, accum_steps: int) -> np.ndarray:
    """``(k, 2)`` float32: each step's updater scalar and learning rate,
    at the update count ``iteration // accum_steps`` (rows of steps that
    only accumulate are 0), resolved at epoch 0 as the JAX fit does."""
    rows = np.zeros((k, 2), np.float32)
    at = [i for i, on in enumerate(apply_positions(start, k, accum_steps))
          if on]
    if at:
        its = [(start + i) // accum_steps for i in at]
        rows[at, 0] = updater.step_scalars(its, 0)
        rows[at, 1] = updater.learning_rates(its, 0)
    return rows


class StepWindow:
    """K train steps of the owner ``sd`` over ``inputs`` (placeholder ->
    a ``(K, batch, ...)`` tensor whose address stays fixed), starting at
    an iteration whose remainder modulo ``accum_steps`` is ``phase``,
    with ``scal``, a ``(K, 2)`` buffer of the steps' updater scalars and
    learning rates, ``iters``, a ``(K,)`` buffer of their absolute
    iterations, ``losses``, a ``(K,)`` buffer of their losses, and
    ``bad`` (with the sentinel), the first bad step's iteration or -1.
    On the card the steps are captured once as a CUDA graph in the
    owner's pool, after warm-up steps whose writes (``warmup_restore_set``
    and the accumulator) are undone, and :meth:`run` replays it; on the
    CPU :meth:`run` runs them eagerly."""

    def __init__(self, sd: StepOwner, names: List[str], state, inputs: Env,
                 k: int, phase: int = 0,
                 accum: Optional[List[torch.Tensor]] = None):
        self.sd, self.names, self.state, self.inputs, self.k = \
            sd, names, state, inputs, k
        tc = sd.training_config
        dev = sd.device
        self.scal = torch.zeros(k, 2, dtype=torch.float32, device=dev)
        self.iters = torch.zeros(k, dtype=torch.int64, device=dev)
        self.losses = torch.zeros(k, dtype=torch.float32, device=dev)
        self.bad = torch.full((1,), -1, dtype=torch.int64, device=dev) \
            if tc.sentinel else None
        self.accum = accum
        self.apply = apply_positions(phase, k, tc.accum_steps)
        #: a warm-up step that runs the apply half where the window may not
        self._force_apply = False
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        #: what one replay adds to the kernel wrappers' counters
        self.counts: _cuda.Counts = []
        if sd.device.type == "cuda":
            self._capture()

    def _step(self, i: int) -> None:
        ph = {n: t[i] for n, t in self.inputs.items()}
        inp = steps.StepInputs(
            self.scal[i], self.iters[i], self.accum,
            self.apply[i] or self._force_apply)
        loss, ok = steps.train_step(self.sd, self.names, ph, self.state, inp)
        self.losses[i].copy_(loss)
        if ok is not None:
            with torch.no_grad():
                self.bad.copy_(torch.where((self.bad < 0) & ~ok,
                                           self.iters[i], self.bad))

    def _body(self) -> None:
        if self.bad is not None:
            self.bad.fill_(-1)
        for i in range(self.k):
            self._step(i)

    def _capture(self) -> None:
        sd = self.sd
        stream = sd._capture_stream()
        live = sd.warmup_restore_set(self.names, self.state) + \
            list(self.accum or [])
        saved = [t.detach().clone() for t in live]
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            for i in range(WARMUP_STEPS):
                # the last warm-up step runs the apply half, which a
                # window of accumulating steps may not reach
                self._force_apply = i == WARMUP_STEPS - 1
                self._step(min(i, self.k - 1))
            self._force_apply = False
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
                self._body()
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
            self._body()


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


def _check_bad_steps(bads, epoch: int, epoch_start: int) -> None:
    from deeplearning4j_tpu_torch.faults.sentinels import check_bad_steps
    check_bad_steps(bads, epoch, epoch_start)


class _Fit:
    """One ``fit``: the tier's units of work, counters, losses, sentinel
    verdicts and listener deliveries."""

    def __init__(self, sd, iterator, listeners):
        self.sd, self.iterator, self.listeners = sd, iterator, listeners
        self.tc = tc = sd.training_config
        self.K = max(1, int(tc.fused_steps))
        self.A = max(1, int(tc.accum_steps))
        if not listeners and hasattr(iterator, "stacked_batches") and \
                self.K <= 1 and self.A <= 1:
            self.tier = "scanned_epoch"
        elif self.K > 1 or self.A > 1:
            self.tier = "windowed"
        else:
            self.tier = "per_step"
        if self.tier != "per_step":
            sd._refuse_random_ops()
        sd._begin_fit_seed()
        self.names, self.state = sd._fit_state()
        self.accum = None
        if self.A > 1:
            self.accum = sd._accumulator(self.names)
            if tc.iteration_count % self.A == 0:
                with torch.no_grad():
                    torch._foreach_zero_(self.accum)
        self.stacked = None
        if self.tier != "per_step" and hasattr(iterator, "stacked_batches"):
            feats, labels = iterator.stacked_batches()
            self.stacked = _bound_inputs(sd, {
                **dict(zip(tc.data_set_feature_mapping, feats)),
                **dict(zip(tc.data_set_label_mapping, labels))})
        self.flush_every = min((max(1, int(getattr(l, "frequency", 10)))
                                for l in listeners), default=0)
        self.next_flush = self._after(tc.iteration_count)
        #: (first iteration, losses, first bad step or None), on the device
        self.pending: List[Tuple[int, torch.Tensor,
                                 Optional[torch.Tensor]]] = []
        self.captures = 0
        #: an eager step's scalar row and iteration, staged before it
        self.scal = torch.zeros(1, 2, dtype=torch.float32, device=sd.device)
        self.it = torch.zeros(1, dtype=torch.int64, device=sd.device)

    def _after(self, iteration: int) -> int:
        f = self.flush_every
        return (iteration // f + 1) * f if f else 0

    # -- units of work ---------------------------------------------------
    def _window(self, k: int, inputs: Optional[Env] = None,
                sig: Optional[Tuple] = None) -> StepWindow:
        """The cached window of ``k`` steps from the current iteration's
        phase over ``inputs`` (bound in place), or over static buffers
        shaped like one batch ``sig``."""
        sd, tc = self.sd, self.tc
        phase = tc.iteration_count % self.A
        step = (phase,) + steps.step_key(tc)
        if inputs is not None:
            key = ("in_place", k, step, tuple(
                (n, tuple(t.shape), t.stride(), t.dtype, t.data_ptr())
                for n, t in inputs.items()))
        else:
            key = ("buffers", k, step, sig)
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
            win = StepWindow(sd, self.names, self.state, inputs, k, phase,
                             self.accum)
            wins[key] = win
            self.captures += 1
            sd.captures_total += 1
        return win

    def _units(self):
        """Yield, in data order, ``(window, fill)`` for a window (``fill``
        copies its inputs into its buffers, or is None) and
        ``(None, placeholders)`` for one eager step. A window is made
        when it is yielded, at its first iteration."""
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

    def _eager_step(self, it: int, ph: Env):
        """One step outside a window: ``((1,) losses, (1,) first bad step
        or None)``."""
        stage_(self.scal, step_rows(self.tc.updater, it, 1, self.A))
        stage_(self.it, np.array([it], np.int64))
        inp = steps.StepInputs(self.scal[0], self.it[0], self.accum,
                               apply_positions(it, 1, self.A)[0])
        loss, ok = steps.train_step(self.sd, self.names, ph, self.state,
                                    inp)
        bad = None if ok is None else torch.where(
            ok, torch.full_like(self.it, -1), self.it)
        return loss.detach().reshape(1), bad

    # -- the loop --------------------------------------------------------
    def _flush(self, epoch: int, epoch_start: int,
               epoch_vals: List[float]) -> None:
        """Fetch the buffered losses (and verdicts), check the verdicts,
        then deliver the burst to the listeners."""
        if not self.pending:
            return
        iters = [it for start, l, _ in self.pending
                 for it in range(start, start + l.shape[0])]
        vals = torch.cat([l for _, l, _ in self.pending]).tolist()
        bads = [b for _, _, b in self.pending if b is not None]
        self.pending.clear()
        if bads:
            _check_bad_steps(torch.cat(bads).tolist(), epoch, epoch_start)
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
            epoch_bads: List[torch.Tensor] = []
            sizes: Dict[int, int] = {}
            windows = eager = 0
            captures0 = self.captures
            for l in listeners:
                l.on_epoch_start(sd, epoch)
            for win, work in self._units():
                it = tc.iteration_count
                if win is None:
                    losses, bad = self._eager_step(it, work)
                    eager += 1
                    k = 1
                else:
                    k = win.k
                    if work is not None:
                        work()
                    stage_(win.scal, step_rows(updater, it, k, self.A))
                    stage_(win.iters, np.arange(it, it + k, dtype=np.int64))
                    win.run()
                    losses = win.losses.clone()
                    bad = None if win.bad is None else win.bad.clone()
                    windows += 1
                sizes[k] = sizes.get(k, 0) + 1
                tc.iteration_count = it + k
                if listeners:
                    self.pending.append((it, losses, bad))
                    # per-step: every flush_every buffered steps; windows:
                    # the first boundary at or after each multiple of it
                    due = len(self.pending) >= self.flush_every \
                        if self.tier == "per_step" \
                        else tc.iteration_count >= self.next_flush
                    if due:
                        self._flush(epoch, start, epoch_vals)
                        self.next_flush = self._after(tc.iteration_count)
                else:
                    epoch_losses.append(losses)
                    if bad is not None:
                        epoch_bads.append(bad)
            if tc.iteration_count == start:
                raise ValueError("fit got no batches")
            if epoch_bads:           # one verdict fetch an epoch
                _check_bad_steps(torch.cat(epoch_bads).tolist(), epoch,
                                 start)
            if listeners:
                self._flush(epoch, start, epoch_vals)
                self.next_flush = self._after(tc.iteration_count)
                history.add_epoch(epoch, float(np.mean(epoch_vals)),
                                  epoch_vals)
            else:
                deferred.append(torch.cat(epoch_losses))
            tc.epoch_count += 1
            sd.last_fit_stats = {
                "tier": self.tier, "fused_steps": self.K,
                "accum_steps": self.A, "sentinel": bool(tc.sentinel),
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


class _TbpttFit(_Fit):
    """One ``fit_tbptt``: minibatches of ``batch`` sequences, each the
    ``n_full`` full chunks of ``length`` timesteps as one window over
    static ``(n_full, batch, length, ...)`` buffers and a ragged tail as
    one eager step, the recurrent ``states`` zeroed before each. It takes
    :class:`_Fit`'s windows and eager steps, with no accumulation."""

    def __init__(self, sd, states: List[str], length: int, batch: int):
        self.sd, self.length, self.batch = sd, int(length), int(batch)
        self.tc = tc = sd.training_config
        if int(tc.accum_steps) != 1:
            raise ValueError("fit_tbptt takes no accum_steps (the TBPTT "
                             "graph's config has its own, 1)")
        self.A, self.accum = 1, None
        sd._refuse_random_ops()
        sd._begin_fit_seed()
        self.states = [sd._arrays[n] for n in states]
        self.names, self.state = sd._fit_state()
        self.scal = torch.zeros(1, 2, dtype=torch.float32, device=sd.device)
        self.it = torch.zeros(1, dtype=torch.int64, device=sd.device)
        self.captures = 0

    def run(self, X, Y, epochs: int) -> History:
        sd, tc, L, B = self.sd, self.tc, self.length, self.batch
        n = (len(X) // B) * B
        t_len = X.shape[1]
        n_full, t_full = t_len // L, (t_len // L) * L
        names = (tc.data_set_feature_mapping[0],
                 tc.data_set_label_mapping[0])
        sig = tuple((nm, (B, L, *a.shape[2:]),
                     sd._placeholder_dtype(nm, a)) for nm, a in
                    zip(names, (X, Y)))
        history = History()
        per_epoch: List[torch.Tensor] = []
        captures: List[int] = []
        for epoch in range(epochs):
            start = tc.iteration_count
            captures0 = self.captures
            losses: List[torch.Tensor] = []
            bads: List[torch.Tensor] = []
            replays = eager = 0
            for i in range(0, n, B):
                with torch.no_grad():        # new sequences: zero carries
                    torch._foreach_zero_(self.states)
                it = tc.iteration_count
                if n_full:
                    win = self._window(n_full, sig=sig)
                    for nm, a in zip(names, (X, Y)):
                        part = a[i:i + B, :t_full]
                        part = part.reshape(B, n_full, L, *a.shape[2:])
                        stage_(win.inputs[nm], part.swapaxes(0, 1))
                    stage_(win.scal, step_rows(tc.updater, it, n_full, 1))
                    stage_(win.iters, np.arange(it, it + n_full,
                                                dtype=np.int64))
                    win.run()
                    losses.append(win.losses.clone())
                    if win.bad is not None:
                        bads.append(win.bad.clone())
                    replays += 1
                    it += n_full
                if t_full < t_len:
                    ph = sd._prep_placeholders({
                        nm: a[i:i + B, t_full:] for nm, a in
                        zip(names, (X, Y))})
                    loss, bad = self._eager_step(it, ph)
                    losses.append(loss)
                    if bad is not None:
                        bads.append(bad)
                    eager += 1
                    it += 1
                tc.iteration_count = it
            if bads:                      # one verdict fetch an epoch
                _check_bad_steps(torch.cat(bads).tolist(), epoch, start)
            per_epoch.append(torch.cat(losses))
            captures.append(self.captures - captures0)
            sd.last_fit_stats = {
                "tier": "tbptt", "tbptt_length": L,
                "chunks_per_minibatch": n_full + (t_full < t_len),
                "minibatches_per_epoch": n // B,
                "steps_per_epoch": tc.iteration_count - start,
                "graph_replays_per_epoch":
                    replays if sd.device.type == "cuda" else 0,
                "eager_steps_per_epoch": eager,
                "window_captures": captures[-1],
                "window_captures_by_epoch": list(captures)}
        flat = torch.cat(per_epoch).tolist()     # one transfer for the fit
        for e, t in enumerate(per_epoch):
            vals, flat = flat[:len(t)], flat[len(t):]
            history.add_epoch(e, float(np.mean(vals)), vals)
        return history


def fit_tbptt(sd: StepOwner, X, Y, length: int, batch: int, epochs: int,
              states: List[str]) -> History:
    """Truncated BPTT over sequences ``X`` [N, T, ...] and ``Y`` [N, T,
    ...] (numpy arrays or tensors; the rows past the last whole batch are
    the caller's to drop) in chunks of ``length`` timesteps, the state
    variables ``states`` zeroed for every minibatch; see the module
    docstring."""
    return _TbpttFit(sd, states, length, batch).run(X, Y, epochs)
