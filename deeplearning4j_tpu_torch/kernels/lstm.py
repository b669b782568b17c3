"""The LSTM recurrence, with its pointwise cell in hand-written CUDA C++
kernels for Hopper.

Counterpart of the JAX package's ``lstm_cell`` and ``lstm_layer``
(``deeplearning4j_tpu/ops/nn_ops.py`` :520-556): gate order ``[i, f, g,
o]``, ``c = f * c_prev + i * g``, ``h = o * tanh(c)``. The JAX layer is a
``lax.scan`` whose body XLA fused; here :class:`LSTMSequence` is one
``torch.autograd.Function`` over the whole sequence:

- forward: one GEMM for every timestep's input projection (``x @ W_ih +
  b``, hoisted out of the loop) into a ``(T, B, 4U)`` buffer; then a step
  adds ``h @ W_hh`` into its row of that buffer (``addmm_``) and launches
  :func:`lstm_cell_fwd`, which activates the gates in place (kept for the
  backward) and writes ``h`` and ``c`` into the ``(T, B, U)`` outputs;
- backward, in reverse time: a launch of :func:`lstm_cell_bwd` (the
  step's ``dh`` is its output gradient plus the carried one, summed in
  the kernel) into a ``(T, B, 4U)`` buffer of ``dz``, then ``dz @
  W_hh^T``, the next carried ``dh``; then ``dx``, ``dW_ih``, ``dW_hh``
  and ``db`` as single GEMMs and a sum over all timesteps, and the
  gradients of ``h0`` and ``c0``.

The products stay ``torch.matmul`` (cuBLAS), as the JAX package left them
to XLA. On the card each cell is one launch of ``csrc/lstm_cell.cu``
(built by ``kernels/_cuda.py``), counted in :data:`LAUNCHES`; it launches
on torch's current stream with no host sync and no allocation, so the fit
tiers capture it. ``lstm_cell_fwd_plain`` / ``lstm_cell_bwd_plain`` are
the same arithmetic in PyTorch: the wrappers take them for CPU tensors
only; on a CUDA tensor they launch the kernel or raise.

Float32 and float64. A half-precision LSTM (``MixedPrecision``) is
refused by name (ROADMAP queue 2b item 11).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.kernels import _cuda

#: Kernel launches, bumped where each kernel is launched.
LAUNCHES: Dict[str, int] = {"lstm_cell_fwd": 0, "lstm_cell_bwd": 0}

_LIB = "lstm_cell"
_DTYPES = {torch.float32: 0, torch.float64: 1}
_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
ARGTYPES = {
    "dl4j_lstm_cell_fwd": ([(n, _P) for n in ("z", "c_prev", "h", "c")]
                           + [("B", _I64), ("U", _I64), ("dtype", _I),
                              ("stream", _P)]),
    "dl4j_lstm_cell_bwd": ([(n, _P) for n in (
        "gates", "c_prev", "c", "dh_up", "dh_next", "dc_next", "dz",
        "dc_prev")] + [("B", _I64), ("U", _I64), ("dtype", _I),
                       ("stream", _P)]),
}

_cuda.register_counters(LAUNCHES)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    """The built library, its C entries' argument types declared."""
    lib = _cuda.load(_LIB)
    for name, args in ARGTYPES.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            _cuda.declare(fn, args)
    return lib


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


# ----------------------------------------------------------------------
# the wrappers
def _check(what: str, rows: torch.Tensor, **ts) -> torch.device:
    """Raise on what the kernels do not take; returns the device."""
    b, u4 = rows.shape
    dev, dt = rows.device, rows.dtype
    for name, t in ts.items():
        if t is None:
            continue
        want = (b, u4) if name in ("z", "gates", "dz") else (b, u4 // 4)
        if tuple(t.shape) != want or t.device != dev or t.dtype != dt:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, want {want} {dt} on {dev}")
        if dev.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    if dt not in _DTYPES:
        raise NotImplementedError(
            f"{what} in {dt} is not ported yet: the LSTM cell takes float32 "
            f"and float64 (ROADMAP queue 2b item 11)")
    return dev


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def lstm_cell_fwd(z: torch.Tensor, c_prev: torch.Tensor, h: torch.Tensor,
                  c: torch.Tensor) -> None:
    """One timestep's cell: ``z`` [B, 4U] (the pre-activations) becomes
    the activated gates in place, ``h`` and ``c`` [B, U] are written. One
    launch on the card, the plain version on the CPU."""
    dev = _check("lstm_cell_fwd", z, z=z, c_prev=c_prev, h=h, c=c)
    if dev.type == "cpu":
        gates, hn, cn = lstm_cell_fwd_plain(z, c_prev)
        z.copy_(gates)
        h.copy_(hn)
        c.copy_(cn)
        return
    b, u = c.shape
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    with torch.cuda.device(dev):
        err = _lib().dl4j_lstm_cell_fwd(
            z.data_ptr(), c_prev.data_ptr(), h.data_ptr(), c.data_ptr(), b, u,
            _DTYPES[z.dtype], stream)
    _cuda.check(err, "dl4j_lstm_cell_fwd")
    LAUNCHES["lstm_cell_fwd"] += 1


def lstm_cell_bwd(gates, c_prev, c, dh_up, dh_next, dc_next, dz,
                  dc_prev) -> None:
    """One timestep's cell gradient: writes ``dz`` [B, 4U] and ``dc_prev``
    [B, U] (which may be ``dc_next`` itself); ``dh_up``, ``dh_next`` and
    ``dc_next`` may be None (zero). One launch on the card, the plain
    version on the CPU."""
    dev = _check("lstm_cell_bwd", gates, gates=gates, c_prev=c_prev, c=c,
                 dh_up=dh_up, dh_next=dh_next, dc_next=dc_next, dz=dz,
                 dc_prev=dc_prev)
    if dev.type == "cpu":
        g, dcp = lstm_cell_bwd_plain(gates, c_prev, c, dh_up, dh_next,
                                     dc_next)
        dz.copy_(g)
        dc_prev.copy_(dcp)
        return
    b, u = c.shape
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    with torch.cuda.device(dev):
        err = _lib().dl4j_lstm_cell_bwd(
            gates.data_ptr(), c_prev.data_ptr(), c.data_ptr(), _ptr(dh_up),
            _ptr(dh_next), _ptr(dc_next), dz.data_ptr(), dc_prev.data_ptr(),
            b, u, _DTYPES[gates.dtype], stream)
    _cuda.check(err, "dl4j_lstm_cell_bwd")
    LAUNCHES["lstm_cell_bwd"] += 1


# ----------------------------------------------------------------------
# the recurrence
class LSTMSequence(torch.autograd.Function):
    """``(hs, hT, cT)`` of an LSTM over ``x`` [B, T, I] from ``h0``,
    ``c0`` [B, U], with ``w_ih`` [I, 4U], ``w_hh`` [U, 4U], ``b`` [4U];
    ``hs`` is [B, T, U] (a view of the time-major [T, B, U] buffer)."""

    @staticmethod
    def forward(ctx, x, h0, c0, w_ih, w_hh, b):
        bsz, t_len, n_in = x.shape
        u = h0.shape[1]
        # time-major rows: a contiguous copy unless x is already a view of
        # a time-major buffer (the layer below's hs)
        x2 = x.transpose(0, 1).reshape(t_len * bsz, n_in)
        gates = torch.addmm(b, x2, w_ih).view(t_len, bsz, 4 * u)
        hs = torch.empty(t_len, bsz, u, dtype=x.dtype, device=x.device)
        cs = torch.empty_like(hs)
        h, c = h0.contiguous(), c0.contiguous()
        for t in range(t_len):
            gates[t].addmm_(h, w_hh)
            lstm_cell_fwd(gates[t], c, hs[t], cs[t])
            h, c = hs[t], cs[t]
        ctx.save_for_backward(x2, h0, c0, w_ih, w_hh, hs, cs, gates)
        return hs.transpose(0, 1), hs[-1], cs[-1]

    @staticmethod
    def backward(ctx, g_hs, g_ht, g_ct):
        x2, h0, c0, w_ih, w_hh, hs, cs, gates = ctx.saved_tensors
        t_len, bsz, u = hs.shape
        d_hs = None if g_hs is None else g_hs.transpose(0, 1).contiguous()
        dz = torch.empty_like(gates)
        dh = torch.zeros_like(h0) if g_ht is None else g_ht.clone(
            memory_format=torch.contiguous_format)
        dc = torch.zeros_like(c0) if g_ct is None else g_ct.clone(
            memory_format=torch.contiguous_format)
        c0c = c0.contiguous()
        w_hh_t = w_hh.t()
        for t in range(t_len - 1, -1, -1):
            lstm_cell_bwd(gates[t], cs[t - 1] if t else c0c, cs[t],
                          None if d_hs is None else d_hs[t], dh, dc, dz[t],
                          dc)
            torch.mm(dz[t], w_hh_t, out=dh)
        dz2 = dz.view(t_len * bsz, 4 * u)
        need = ctx.needs_input_grad
        dx = (dz2 @ w_ih.t()).view(t_len, bsz, -1).transpose(0, 1) \
            if need[0] else None
        dw_ih = x2.t() @ dz2 if need[3] else None
        dw_hh = None
        if need[4]:
            dw_hh = h0.t() @ dz[0]
            if t_len > 1:
                dw_hh = torch.addmm(dw_hh, hs[:-1].reshape(-1, u).t(),
                                    dz[1:].reshape(-1, 4 * u))
        db = dz2.sum(0) if need[5] else None
        return (dx, dh if need[1] else None, dc if need[2] else None, dw_ih,
                dw_hh, db)


def lstm_sequence(x, h0, c0, w_ih, w_hh, b):
    """``(hs [B, T, U], hT, cT)``: the LSTM over ``x`` [B, T, I]
    (:class:`LSTMSequence`)."""
    if x.dim() != 3 or h0.dim() != 2 or c0.shape != h0.shape:
        raise ValueError(f"lstm: x {tuple(x.shape)} must be [B, T, I] and "
                         f"h0 {tuple(h0.shape)}, c0 {tuple(c0.shape)} [B, U]")
    if x.dtype not in _DTYPES:
        raise NotImplementedError(
            f"an LSTM in {x.dtype} is not ported yet: the cell kernels take "
            f"float32 and float64 (ROADMAP queue 2b item 11)")
    if x.shape[1] == 0:
        raise ValueError("lstm: a sequence of no timesteps")
    return LSTMSequence.apply(x, h0, c0, w_ih, w_hh, b)
