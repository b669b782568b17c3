"""What the cluster recurrence kernels' wrappers share: ``kernels/lstm.py``
(``csrc/lstm_recurrence.cu``, the LSTM) and ``kernels/recurrence.py``
(``csrc/rnn_recurrence.cu``, the GRU, peephole LSTM and simple RNN).

- the dtypes the kernels take, the cluster's split of the units over its
  blocks and a block's shared memory on Hopper;
- the libraries' loading, the tensor checks and the card's occupancy;
- :class:`Sequence`, the one ``torch.autograd.Function`` over a whole
  sequence that every cell runs through: one GEMM for every timestep's
  input projection (``x @ W_ih + b``, hoisted out of the loop) into a
  time-major ``(T, B, GU)`` buffer, the cell's forward kernel, and after
  its backward kernel ``dx``, ``dW_ih``, ``dW_hh`` and the biases' (and
  the peepholes') gradients as GEMMs and sums over all timesteps.

A cell is a :class:`Cell`: its gate columns a unit and its two kernel
wrappers, which launch on the card and take the plain versions for CPU
tensors only.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.kernels import _cuda

#: the dtypes the kernels take and their C codes
DTYPES: Dict[torch.dtype, int] = {torch.float32: 0, torch.float64: 1}
#: blocks a cluster at most (above 8: the non-portable cluster size)
MAX_RANKS = 16
#: a block's shared memory on Hopper (bytes)
SMEM_LIMIT = 232448


def split_units(u: int) -> Tuple[int, int]:
    """(blocks a cluster, units a block) for ``u`` units: about 16 units a
    block, at most :data:`MAX_RANKS` blocks, then as few blocks as that
    many units a block needs (each block owns at least one unit, so none
    waits at the cluster's barriers idle)."""
    ranks = min(MAX_RANKS, max(1, -(-u // 16)))
    units = -(-u // ranks)
    return -(-u // units), units


def load(lib: str, argtypes) -> ctypes.CDLL:
    """The built library ``lib``, its C entries' argument types declared
    (``argtypes``: entry name -> [(argument name, ctypes type)])."""
    out = _cuda.load(lib)
    for name, args in argtypes.items():
        fn = getattr(out, name)
        if fn.argtypes is None:
            _cuda.declare(fn, args)
    return out


def refuse_dtype(what: str, dtype: torch.dtype) -> None:
    if dtype not in DTYPES:
        raise NotImplementedError(
            f"{what} in {dtype} is not ported yet: the recurrence kernels "
            f"take float32 and float64 (ROADMAP queue 2b item 11)")


def check(what: str, dtype: torch.dtype, dev: torch.device, **ts) -> None:
    """Raise on what the kernels do not take: ``ts`` maps a name to (the
    tensor or None, its shape)."""
    refuse_dtype(what, dtype)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    for name, (t, want) in ts.items():
        if t is None:
            continue
        if tuple(t.shape) != want or t.device != dev or t.dtype != dtype:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, want {want} {dtype} on {dev}")
        if dev.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def occupancy(index: int, query: Callable[..., Tuple[int, int, int, int]]
              ) -> Callable[..., int]:
    """``occupancy(*a)``: the clusters card ``index`` holds at once of
    both kernels, from ``query(*a)`` (the C side's (forward bytes,
    backward bytes, forward clusters, backward clusters))."""
    def clusters(*a) -> int:
        with torch.cuda.device(index):
            q = query(*a)
        return min(q[2], q[3])
    return clusters


@dataclasses.dataclass(frozen=True)
class Cell:
    """A recurrence's kernels as :class:`Sequence` runs them.

    ``fwd(gx, w_hh, h0, c0, b_hh, w_peep)`` -> ``(saved, hs, cs, hn)``:
    ``gx`` [T, B, GU] overwritten by what the backward needs (``saved`` is
    ``gx``), the hidden states [T, B, U], the cell states (or None) and
    the GRU's candidate hidden part (or None).
    ``bwd(saved, hs, cs, hn, h0, c0, w_hh, w_peep, d_hs, dh_T, dc_T)`` ->
    ``(dz, dzh, dh0, dc0)``: the gradients of ``gx`` and of ``h @ W_hh +
    b_hh`` (the same tensor but for the GRU), of ``h0`` and of ``c0`` (or
    None)."""
    name: str
    gates: int
    carries_c: bool
    fwd: Callable
    bwd: Callable


def _c(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.contiguous()


class Sequence(torch.autograd.Function):
    """The ``cell`` recurrence over ``x`` [B, T, I] from ``h0`` (and
    ``c0`` where the cell carries one) [B, U], with ``w_ih`` [I, GU],
    ``w_hh`` [U, GU], ``b`` [GU], the GRU's ``b_hh`` [GU] and the peephole
    LSTM's ``w_peep`` [3, U]; returns ``(hs [B, T, U], hT)`` and ``cT``
    where the cell carries one. ``hs`` is a view of the time-major [T, B,
    U] buffer."""

    @staticmethod
    def forward(ctx, cell, x, h0, c0, w_ih, w_hh, b, b_hh, w_peep):
        # an output nothing reads gets no gradient (None), not zeros: the
        # backward kernel then reads no d_hs (return_sequences=False)
        ctx.set_materialize_grads(False)
        bsz, t_len, n_in = x.shape
        u = h0.shape[1]
        # time-major rows: a contiguous copy unless x is already a view of
        # a time-major buffer (the layer below's hs)
        x2 = x.transpose(0, 1).reshape(t_len * bsz, n_in)
        gx = torch.addmm(b, x2, w_ih).view(t_len, bsz, cell.gates * u)
        saved, hs, cs, hn = cell.fwd(gx, w_hh.contiguous(), h0.contiguous(),
                                     _c(c0), _c(b_hh), _c(w_peep))
        ctx.cell = cell
        ctx.save_for_backward(x2, h0, c0, w_ih, w_hh, w_peep, hs, cs, hn,
                              saved)
        if cell.carries_c:
            return hs.transpose(0, 1), hs[-1], cs[-1]
        return hs.transpose(0, 1), hs[-1]

    @staticmethod
    def backward(ctx, g_hs, g_ht, g_ct=None):
        x2, h0, c0, w_ih, w_hh, w_peep, hs, cs, hn, saved = ctx.saved_tensors
        t_len, bsz, u = hs.shape
        gu = saved.shape[2]
        d_hs = None if g_hs is None else g_hs.transpose(0, 1).contiguous()
        dz, dzh, dh0, dc0 = ctx.cell.bwd(
            saved, hs, cs, hn, h0.contiguous(), _c(c0), w_hh.contiguous(),
            _c(w_peep), d_hs, _c(g_ht), _c(g_ct))
        dz2 = dz.view(t_len * bsz, gu)
        need = ctx.needs_input_grad
        dx = (dz2 @ w_ih.t()).view(t_len, bsz, -1).transpose(0, 1) \
            if need[1] else None
        dw_ih = x2.t() @ dz2 if need[4] else None
        dw_hh = None
        if need[5]:
            dw_hh = h0.t() @ dzh[0]
            if t_len > 1:
                dw_hh = torch.addmm(dw_hh, hs[:-1].reshape(-1, u).t(),
                                    dzh[1:].reshape(-1, gu))
        db = dz2.sum(0) if need[6] else None
        db_hh = dzh.view(t_len * bsz, gu).sum(0) if need[7] else None
        dw_p = None
        if w_peep is not None and need[8]:
            cp = torch.cat([c0.unsqueeze(0), cs[:-1]]) if t_len > 1 \
                else c0.unsqueeze(0)
            dw_p = torch.stack([(dz[..., :u] * cp).sum((0, 1)),
                                (dz[..., u:2 * u] * cp).sum((0, 1)),
                                (dz[..., 3 * u:] * cs).sum((0, 1))])
        return (None, dx, dh0 if need[2] else None,
                dc0 if need[3] else None, dw_ih, dw_hh, db, db_hh, dw_p)


def sequence(cell: Cell, x, h0, w_ih, w_hh, b, c0=None, b_hh=None,
             w_peep=None):
    """``(hs [B, T, U], hT)`` (``(hs, hT, cT)`` where the cell carries a
    cell state) of the ``cell`` recurrence over ``x`` [B, T, I]
    (:class:`Sequence`)."""
    if x.dim() != 3 or h0.dim() != 2 or (c0 is not None
                                         and c0.shape != h0.shape):
        raise ValueError(
            f"{cell.name}: x {tuple(x.shape)} must be [B, T, I] and h0 "
            f"{tuple(h0.shape)}" + ("" if c0 is None else
                                    f", c0 {tuple(c0.shape)}") + " [B, U]")
    refuse_dtype(f"the {cell.name} recurrence", x.dtype)
    if x.shape[1] == 0:
        raise ValueError(f"{cell.name}: a sequence of no timesteps")
    return Sequence.apply(cell, x, h0, c0, w_ih, w_hh, b, b_hh, w_peep)
