"""The LSTM recurrence, each layer's and direction's whole sequence one
hand-written CUDA C++ kernel for Hopper.

Counterpart of the JAX package's ``lstm_cell`` and ``lstm_layer``
(``deeplearning4j_tpu/ops/nn_ops.py`` :520-556): gate order ``[i, f, g,
o]``, ``c = f * c_prev + i * g``, ``h = o * tanh(c)``. The JAX layer is a
``lax.scan`` whose body (``h_prev @ w_hh`` and the cell) XLA fused; here
:func:`lstm_sequence` runs the LSTM's :data:`CELL` through
``kernels/_sequence.py``'s ``Sequence``, the one ``torch.autograd.Function``
over a whole sequence that every recurrence kernel of the port shares:

- forward: one GEMM for every timestep's input projection (``x @ W_ih +
  b``, hoisted out of the loop) into a time-major ``(T, B, 4U)`` buffer;
  then one launch of :func:`lstm_recurrence_fwd`, which adds ``h_{t-1} @
  W_hh`` a step, activates the gates (written over that buffer, kept for
  the backward) and writes ``h`` and ``c`` into ``(T, B, U)`` outputs;
- backward: one launch of :func:`lstm_recurrence_bwd` over reverse time
  (the cell's gradient and ``dz_t @ W_hh^T``, the carried ``dh``, a step)
  into a ``(T, B, 4U)`` buffer of ``dz`` and the gradients of ``h0`` and
  ``c0``; then ``dx``, ``dW_ih``, ``dW_hh`` and ``db`` as single GEMMs
  and a sum over all timesteps.

On the card both are ``csrc/lstm_recurrence.cu`` (built by
``kernels/_cuda.py``): a thread-block cluster keeps ``W_hh`` in its
blocks' shared memory for the whole sequence (past the widths where it
fits, the streamed form reads it from L2 each step, at any width), and
each launch is counted in :data:`LAUNCHES`. :func:`recurrence_plan` picks
the cluster's blocks, its batch rows and the form. The launches go
on torch's current stream with no host sync and no allocation, so the fit
tiers capture them. ``lstm_recurrence_fwd_plain`` /
``lstm_recurrence_bwd_plain`` are the same recurrence in PyTorch (a loop
of ``addmm`` and the plain cell, ``lstm_cell_fwd_plain`` /
``lstm_cell_bwd_plain``): the wrappers take them for CPU tensors only; on
a CUDA tensor they launch the kernel or raise.

Float32 and float64. A half-precision LSTM (``MixedPrecision``) is
refused by name (ROADMAP queue 2b item 11).
"""
from __future__ import annotations

import ctypes
import functools
import logging
from typing import Callable, Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.kernels import _cuda, _sequence
from deeplearning4j_tpu_torch.kernels._sequence import (  # noqa: F401
    DTYPES as _DTYPES, MAX_RANKS, SMEM_LIMIT, check as _check, ptr as _ptr)

#: Kernel launches, bumped where each kernel is launched: one a layer, a
#: direction and a sequence.
LAUNCHES: Dict[str, int] = {"lstm_recurrence_fwd": 0, "lstm_recurrence_bwd": 0}

_LIB = "lstm_recurrence"
_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SPLIT = [("R", _I), ("nt", _I), ("resident", _I), ("dtype", _I)]
ARGTYPES = {
    "dl4j_lstm_recurrence_fwd": (
        [(n, _P) for n in ("z", "w_hh", "h0", "c0", "hs", "cs")]
        + [("T", _I64), ("B", _I64), ("U", _I64)] + _SPLIT
        + [("stream", _P)]),
    "dl4j_lstm_recurrence_bwd": (
        [(n, _P) for n in ("gates", "cs", "c0", "w_hh", "d_hs", "dh_T",
                           "dc_T", "dz", "dh0", "dc0")]
        + [("T", _I64), ("B", _I64), ("U", _I64)] + _SPLIT
        + [("stream", _P)]),
    "dl4j_lstm_recurrence_query": (
        [("U", _I64)] + _SPLIT + [("out", _P)]),
}

_cuda.register_counters(LAUNCHES)
_LOG = logging.getLogger(__name__)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    """The built library, its C entries' argument types declared."""
    return _sequence.load(_LIB, ARGTYPES)


# ----------------------------------------------------------------------
# the launch plan (the C side's work split and shared memory, in Python)
#: a resident cluster's batch rows are this many tiles of 8, in the order
#: tried (the streamed form takes one)
N_TILES = (1, 2, 4)
#: how the kernels split an LSTM (``_sequence.Plan``)
Plan = _sequence.Plan


def recurrence_geometry(u: int, ranks: int, n_tiles: int, resident: bool,
                        itemsize: int) -> Tuple[int, int]:
    """(forward, backward) shared memory of a block in bytes
    (``csrc/lstm_recurrence.cu``): the resident form's ``RecGeo`` for
    ``u`` units over ``ranks`` blocks and ``n_tiles`` tiles of 8 batch
    rows, or the streamed form's partial products (a warp's m32n8
    forward, m16n8 backward); ``_sequence.recurrence_geometry`` of the
    LSTM cell."""
    return _sequence.recurrence_geometry("lstm", u, ranks, n_tiles,
                                         resident, itemsize)


def recurrence_plan(b: int, u: int, itemsize: int,
                    occupancy: Optional[Callable[[int, int, bool], int]]
                    = None) -> Plan:
    """The plan for ``b`` batch rows of ``u`` units of ``itemsize`` bytes
    (``_sequence.plan`` over :data:`N_TILES`): R and the units a block
    ``_sequence.split_units``; the ``W_hh`` slice resident where both
    directions fit :data:`SMEM_LIMIT` with it, else the streamed form (8
    rows a cluster) at any width; the resident batch tile the fewest rows
    a cluster (the shortest step) for which the launch's clusters all fit
    on the card at once, ``occupancy(ranks, n_tiles, resident)`` clusters
    (the card's calculator; None: no limit), else the tile with the
    fewest waves."""
    if b < 1 or u < 1:
        raise ValueError(f"an LSTM of {b} rows and {u} units")
    return _sequence.plan("lstm", b, u, itemsize, N_TILES, occupancy)


def query(u: int, ranks: int, n_tiles: int, resident: bool,
          dtype: torch.dtype) -> Tuple[int, int, int, int]:
    """(forward bytes, backward bytes, forward clusters, backward
    clusters): the C side's shared memory a block and the clusters the
    current card holds at once (its occupancy calculator; needs a
    card)."""
    out = (ctypes.c_int64 * 4)()
    err = _lib().dl4j_lstm_recurrence_query(
        u, ranks, n_tiles, int(resident), _DTYPES[dtype],
        ctypes.addressof(out))
    _cuda.check(err, "dl4j_lstm_recurrence_query")
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _card_plan(index: int, dtype: torch.dtype, b: int, u: int) -> Plan:
    """The plan on card ``index``, its occupancy asked once a shape (on a
    first, eager launch: the fit tiers warm up before they capture)."""
    occupancy = _sequence.occupancy(
        index, lambda ranks, nt, resident: query(u, ranks, nt, resident,
                                                 dtype))
    plan = recurrence_plan(b, u, torch.empty((), dtype=dtype).element_size(),
                           occupancy)
    _LOG.info("lstm recurrence on cuda:%d, %s, B %d, U %d: R %d (%d units a "
              "block), %d rows a cluster, %d clusters (the card holds %s at "
              "once), W_hh slice %s, shared memory %d / %d bytes", index,
              dtype, b, u, plan.ranks, plan.units, plan.b_tile,
              plan.clusters, plan.max_clusters,
              "resident" if plan.resident else "streamed from L2",
              plan.smem_fwd, plan.smem_bwd)
    return plan


# ----------------------------------------------------------------------
# the plain versions
def lstm_cell_fwd_plain(z: torch.Tensor, c_prev: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(gates, h, c)``: the activated gates ``[i, f, g, o]`` of the
    pre-activations ``z`` [B, 4U], and the new hidden and cell state."""
    i, f, g, o = z.chunk(4, dim=-1)
    i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                  torch.sigmoid(o))
    c = f * c_prev + i * g
    return torch.cat([i, f, g, o], dim=-1), o * torch.tanh(c), c


def lstm_cell_bwd_plain(gates, c_prev, c, dh_up=None, dh_next=None,
                        dc_next=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dz, dc_prev)``: the gradients of the pre-activations and of
    ``c_prev``, from the saved gates, ``c_prev``, ``c``, the step's output
    gradient ``dh_up``, the carried ``dh_next`` and ``dc_next`` (None is
    zero)."""
    i, f, g, o = gates.chunk(4, dim=-1)
    zero = torch.zeros_like(c)
    dh = (zero if dh_up is None else dh_up) + \
        (zero if dh_next is None else dh_next)
    tc = torch.tanh(c)
    dc = (zero if dc_next is None else dc_next) + dh * o * (1 - tc * tc)
    dz = torch.cat([dc * g * i * (1 - i), dc * c_prev * f * (1 - f),
                    dc * i * (1 - g * g), dh * tc * o * (1 - o)], dim=-1)
    return dz, dc * f


def lstm_recurrence_fwd_plain(gx, w_hh, h0, c0
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """``(gates, hs, cs)``: the recurrence over ``gx`` [T, B, 4U] (each
    step's ``x @ W_ih + b``) from ``h0``, ``c0`` [B, U]: a step ``z =
    gx_t + h_{t-1} @ w_hh`` (``addmm``) and the plain cell; the activated
    gates [T, B, 4U], the hidden and cell states [T, B, U]."""
    t_len, bsz, u4 = gx.shape
    gates = torch.empty_like(gx)
    hs = gx.new_empty(t_len, bsz, u4 // 4)
    cs = torch.empty_like(hs)
    h, c = h0, c0
    for t in range(t_len):
        gates[t], h, c = lstm_cell_fwd_plain(torch.addmm(gx[t], h, w_hh), c)
        hs[t], cs[t] = h, c
    return gates, hs, cs


def lstm_recurrence_bwd_plain(gates, cs, c0, w_hh, d_hs=None, dh_T=None,
                              dc_T=None) -> Tuple[torch.Tensor, torch.Tensor,
                                                  torch.Tensor]:
    """``(dz, dh0, dc0)``: the recurrence's gradient in reverse time from
    the saved gates [T, B, 4U], ``cs`` [T, B, U], ``c0``, the output
    gradient ``d_hs`` [T, B, U] and ``dh_T``, ``dc_T`` [B, U] (None is
    zero): a step the plain cell's gradient, then ``dz_t @ w_hh^T``, the
    carried ``dh``."""
    dz = torch.empty_like(gates)
    dh, dc = dh_T, dc_T
    w_hh_t = w_hh.t()
    for t in range(gates.shape[0] - 1, -1, -1):
        dz[t], dc = lstm_cell_bwd_plain(
            gates[t], cs[t - 1] if t else c0, cs[t],
            None if d_hs is None else d_hs[t], dh, dc)
        dh = dz[t] @ w_hh_t
    return dz, dh, dc


# ----------------------------------------------------------------------
# the wrappers
def lstm_recurrence_fwd(gx: torch.Tensor, w_hh: torch.Tensor,
                        h0: torch.Tensor, c0: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(gates, hs, cs)`` of :func:`lstm_recurrence_fwd_plain`, with
    ``gx`` [T, B, 4U] overwritten by the activated gates (``gates`` is
    ``gx``). One launch on the card, the plain version on the CPU."""
    if gx.dim() != 3 or gx.shape[2] % 4:
        raise ValueError(f"lstm_recurrence_fwd: gx {tuple(gx.shape)} must "
                         f"be [T, B, 4U]")
    t_len, bsz, u4 = gx.shape
    u = u4 // 4
    dev = gx.device
    _check("lstm_recurrence_fwd", gx.dtype, dev, gx=(gx, (t_len, bsz, u4)),
           w_hh=(w_hh, (u, u4)), h0=(h0, (bsz, u)), c0=(c0, (bsz, u)))
    if dev.type == "cpu":
        gates, hs, cs = lstm_recurrence_fwd_plain(gx, w_hh, h0, c0)
        gx.copy_(gates)
        return gx, hs, cs
    plan = _card_plan(dev.index, gx.dtype, bsz, u)
    hs = gx.new_empty(t_len, bsz, u)
    cs = torch.empty_like(hs)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    with torch.cuda.device(dev):
        err = _lib().dl4j_lstm_recurrence_fwd(
            gx.data_ptr(), w_hh.data_ptr(), h0.data_ptr(), c0.data_ptr(),
            hs.data_ptr(), cs.data_ptr(), t_len, bsz, u, plan.ranks,
            plan.n_tiles, int(plan.resident), _DTYPES[gx.dtype], stream)
    _cuda.check(err, "dl4j_lstm_recurrence_fwd")
    LAUNCHES["lstm_recurrence_fwd"] += 1
    return gx, hs, cs


def lstm_recurrence_bwd(gates: torch.Tensor, cs: torch.Tensor,
                        c0: torch.Tensor, w_hh: torch.Tensor,
                        d_hs: Optional[torch.Tensor] = None,
                        dh_T: Optional[torch.Tensor] = None,
                        dc_T: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dz, dh0, dc0)`` of :func:`lstm_recurrence_bwd_plain` (``d_hs``,
    ``dh_T`` and ``dc_T`` may be None: zero). One launch on the card, the
    plain version on the CPU."""
    if gates.dim() != 3 or gates.shape[2] % 4:
        raise ValueError(f"lstm_recurrence_bwd: gates {tuple(gates.shape)} "
                         f"must be [T, B, 4U]")
    t_len, bsz, u4 = gates.shape
    u = u4 // 4
    dev = gates.device
    _check("lstm_recurrence_bwd", gates.dtype, dev,
           gates=(gates, (t_len, bsz, u4)), cs=(cs, (t_len, bsz, u)),
           c0=(c0, (bsz, u)), w_hh=(w_hh, (u, u4)),
           d_hs=(d_hs, (t_len, bsz, u)), dh_T=(dh_T, (bsz, u)),
           dc_T=(dc_T, (bsz, u)))
    if dev.type == "cpu":
        return lstm_recurrence_bwd_plain(gates, cs, c0, w_hh, d_hs, dh_T,
                                         dc_T)
    plan = _card_plan(dev.index, gates.dtype, bsz, u)
    dz = torch.empty_like(gates)
    dh0, dc0 = torch.empty_like(c0), torch.empty_like(c0)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    with torch.cuda.device(dev):
        err = _lib().dl4j_lstm_recurrence_bwd(
            gates.data_ptr(), cs.data_ptr(), c0.data_ptr(), w_hh.data_ptr(),
            _ptr(d_hs), _ptr(dh_T), _ptr(dc_T), dz.data_ptr(),
            dh0.data_ptr(), dc0.data_ptr(), t_len, bsz, u, plan.ranks,
            plan.n_tiles, int(plan.resident), _DTYPES[gates.dtype], stream)
    _cuda.check(err, "dl4j_lstm_recurrence_bwd")
    LAUNCHES["lstm_recurrence_bwd"] += 1
    return dz, dh0, dc0


# ----------------------------------------------------------------------
# the recurrence
def _fwd(gx, w_hh, h0, c0, b_hh, w_peep):
    gates, hs, cs = lstm_recurrence_fwd(gx, w_hh, h0, c0)
    return gates, hs, cs, None


def _bwd(saved, hs, cs, hn, h0, c0, w_hh, w_peep, d_hs, dh_T, dc_T):
    dz, dh0, dc0 = lstm_recurrence_bwd(saved, cs, c0, w_hh, d_hs, dh_T, dc_T)
    return dz, dz, dh0, dc0


#: the LSTM's kernels as ``_sequence.Sequence`` runs them
CELL = _sequence.Cell("lstm", 4, True, _fwd, _bwd)


def lstm_sequence(x, h0, c0, w_ih, w_hh, b):
    """``(hs [B, T, U], hT, cT)``: the LSTM over ``x`` [B, T, I] from
    ``h0``, ``c0`` [B, U], with ``w_ih`` [I, 4U], ``w_hh`` [U, 4U], ``b``
    [4U] (``_sequence.Sequence``; ``hs`` a view of the time-major [T, B,
    U] buffer)."""
    return _sequence.sequence(CELL, x, h0, w_ih, w_hh, b, c0=c0)
