"""The GRU, peephole (Graves) LSTM and simple RNN recurrences, each layer's
and direction's whole sequence one hand-written CUDA C++ kernel for
Hopper.

Counterparts of the JAX package's ``gru_cell`` / ``gru_layer``
(``deeplearning4j_tpu/ops/nn_ops.py`` :569-592), ``simple_rnn_cell`` /
``simple_rnn_layer`` (:595-624) and ``graves_lstm_cell`` /
``graves_lstm_layer`` (``deeplearning4j_tpu/ops/nn_ext.py`` :29-64), each a
``lax.scan`` whose body XLA fused. Here :func:`recurrence_sequence` runs
each cell through ``kernels/_sequence.py``'s ``Sequence``, the one
``torch.autograd.Function`` over a whole sequence that the LSTM
(``kernels/lstm.py``) runs through too:

- forward: one GEMM for every timestep's input projection (``x @ W_ih +
  b_ih``) into a time-major ``(T, B, GU)`` buffer (G gate columns a unit:
  GRU 3, ``[r, u, c]``; Graves 4, ``[i, f, g, o]``; simple RNN 1), then one
  launch of :func:`recurrence_fwd`, which adds ``h_{t-1} @ W_hh`` a step,
  runs the cell, keeps what the backward needs over that buffer (and the
  GRU's candidate hidden part ``hn``, the Graves cell states ``cs``) and
  writes ``h`` into a ``(T, B, U)`` output;
- backward: one launch of :func:`recurrence_bwd` over reverse time into
  ``dz`` (the gradient of ``x @ W_ih + b_ih``) and ``dzh`` (that of ``h @
  W_hh + b_hh``: the GRU's candidate column differs by ``r``, the other
  cells' is ``dz``), ``dh0`` and the Graves ``dc0``; then ``dx``,
  ``dW_ih``, ``dW_hh``, the biases' and the peepholes' gradients as GEMMs
  and sums over all timesteps.

On the card both are instantiations of the LSTM's cluster engine,
``csrc/lstm_recurrence.cu`` (built by ``kernels/_cuda.py``; its C entries
``dl4j_rnn_recurrence_*``): a thread-block cluster of up to 16 blocks a
tile of 8 or 16 batch rows, each block keeping its share of ``W_hh`` in
shared memory for the whole sequence (the resident form) or reading it
from L2 each step (the streamed form, any width), the step's product
3xTF32 on the tensor cores with the cell run on its accumulators, ``h``
(the backward's partial ``dh``) pushed through distributed shared memory,
one cluster barrier a step. Each launch is counted in :data:`LAUNCHES`;
:func:`recurrence_plan` picks the cluster's blocks, its batch rows and
the form. The launches go on torch's current stream with no host sync and
no allocation, so the fit tiers capture them.
:func:`recurrence_fwd_plain` / :func:`recurrence_bwd_plain` are the same
recurrences in PyTorch (a loop of ``addmm`` and the plain cells): the
wrappers take them for CPU tensors only; on a CUDA tensor they launch the
kernel or raise.

Float32 and float64; half precision is refused by name (ROADMAP queue 2b
item 11). The simple RNN's kernel takes the activations of
:data:`ACTIVATIONS`; any other is refused by name (queue 2b item 14).
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

#: the cells, their C codes and gate columns a unit
CELLS = {"gru": 0, "graves": 1, "simple": 2}
GATES = {"gru": 3, "graves": 4, "simple": 1}

#: the simple RNN's activations (registry op names) and their C codes
ACTIVATIONS = {"identity": 0, "linear": 0, "tanh": 1, "relu": 2,
               "sigmoid": 3, "leaky_relu": 4, "leakyrelu": 4,
               "hard_tanh": 5, "hardtanh": 5, "softsign": 6}

#: Kernel launches, bumped where each kernel is launched: one a layer, a
#: direction and a sequence.
LAUNCHES: Dict[str, int] = {f"{c}_recurrence_{d}": 0 for c in CELLS
                            for d in ("fwd", "bwd")}
_cuda.register_counters(LAUNCHES)

#: the engine's library (``csrc/lstm_recurrence.cu``, the LSTM's too)
_LIB = "lstm_recurrence"
_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SPLIT = [("R", _I), ("resident", _I), ("act", _I), ("dtype", _I)]
ARGTYPES = {
    "dl4j_rnn_recurrence_fwd": (
        [("cell", _I)]
        + [(n, _P) for n in ("z", "w_hh", "b_hh", "w_peep", "h0", "c0", "hs",
                             "cs", "hn")]
        + [("T", _I64), ("B", _I64), ("U", _I64)] + _SPLIT
        + [("stream", _P)]),
    "dl4j_rnn_recurrence_bwd": (
        [("cell", _I)]
        + [(n, _P) for n in ("z", "hs", "cs", "hn", "h0", "c0", "w_hh",
                             "w_peep", "d_hs", "dh_T", "dc_T", "dz", "dzh",
                             "dh0", "dc0")]
        + [("T", _I64), ("B", _I64), ("U", _I64)] + _SPLIT
        + [("stream", _P)]),
    "dl4j_rnn_recurrence_query": (
        [("cell", _I), ("U", _I64), ("R", _I), ("resident", _I),
         ("dtype", _I), ("out", _P)]),
}
_LOG = logging.getLogger(__name__)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    """The built library, its C entries' argument types declared."""
    return _sequence.load(_LIB, ARGTYPES)


def activation_code(name: str) -> int:
    """The kernel's code of a simple RNN activation (a registry op name)."""
    code = ACTIVATIONS.get(name.lower())
    if code is None:
        raise NotImplementedError(
            f"a simple RNN with activation {name!r} is not ported yet: the "
            f"recurrence kernel takes {sorted(set(ACTIVATIONS))} (ROADMAP "
            f"queue 2b item 14)")
    return code


# ----------------------------------------------------------------------
# the launch plan (the C side's work split and shared memory, in Python)
#: a resident cluster's batch rows are this many tiles of 8, in the order
#: tried (the streamed form takes one)
N_TILES = (1, 2)
#: how the kernels split a recurrence (``_sequence.Plan``)
Plan = _sequence.Plan


def recurrence_geometry(cell: str, u: int, ranks: int, n_tiles: int,
                        resident: bool, itemsize: int) -> Tuple[int, int]:
    """(forward, backward) shared memory of a block in bytes
    (``csrc/lstm_recurrence.cu`` ``RecGeo`` of the cell;
    ``_sequence.recurrence_geometry``)."""
    return _sequence.recurrence_geometry(cell, u, ranks, n_tiles, resident,
                                         itemsize)


def recurrence_plan(cell: str, b: int, u: int, itemsize: int,
                    occupancy: Optional[Callable[[int, int, bool], int]]
                    = None) -> Plan:
    """The plan for a ``cell`` recurrence of ``b`` batch rows and ``u``
    units of ``itemsize`` bytes (``_sequence.plan`` over
    :data:`N_TILES`): R and the units a block ``_sequence.split_units``;
    resident where both directions' shared memory fits
    :data:`SMEM_LIMIT`, else streamed; the resident batch tile the fewest
    rows a cluster for which all clusters fit on the card at once,
    ``occupancy(ranks, n_tiles, resident)`` (None: no limit)."""
    if cell not in CELLS:
        raise ValueError(f"unknown recurrence cell {cell!r}")
    if b < 1 or u < 1:
        raise ValueError(f"a recurrence of {b} rows and {u} units")
    return _sequence.plan(cell, b, u, itemsize, N_TILES, occupancy)


def _tiles(plan: Plan) -> int:
    """The C entries' ``resident``: 0 the streamed form, else the
    resident form's batch tiles."""
    return plan.n_tiles if plan.resident else 0


def query(cell: str, u: int, ranks: int, n_tiles: int, resident: bool,
          dtype: torch.dtype) -> Tuple[int, int, int, int]:
    """(forward bytes, backward bytes, forward clusters, backward
    clusters): the C side's shared memory a block and the clusters the
    current card holds at once (needs a card)."""
    out = (ctypes.c_int64 * 4)()
    err = _lib().dl4j_rnn_recurrence_query(
        CELLS[cell], u, ranks, n_tiles if resident else 0, _DTYPES[dtype],
        ctypes.addressof(out))
    _cuda.check(err, "dl4j_rnn_recurrence_query")
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _card_plan(index: int, cell: str, dtype: torch.dtype, b: int,
               u: int) -> Plan:
    """The plan on card ``index``, its occupancy asked once a shape (on a
    first, eager launch: the fit tiers warm up before they capture)."""
    occupancy = _sequence.occupancy(
        index, lambda ranks, nt, resident: query(cell, u, ranks, nt,
                                                 resident, dtype))
    plan = recurrence_plan(cell, b, u,
                           torch.empty((), dtype=dtype).element_size(),
                           occupancy)
    _LOG.info("%s recurrence on cuda:%d, %s, B %d, U %d: R %d (%d units a "
              "block), %d rows a cluster, %d clusters (the card holds %s at "
              "once), W_hh %s, shared memory %d / %d bytes", cell, index,
              dtype, b, u, plan.ranks, plan.units, plan.b_tile,
              plan.clusters, plan.max_clusters,
              "resident" if plan.resident else "streamed from L2",
              plan.smem_fwd, plan.smem_bwd)
    return plan


# ----------------------------------------------------------------------
# the plain versions
def _leaky(z):
    return torch.where(z >= 0, z, 0.01 * z)


def _hard_tanh(z):
    return z.clamp(-1.0, 1.0)


_ACT_FWD = {0: lambda z: z, 1: torch.tanh, 2: torch.relu, 3: torch.sigmoid,
            4: _leaky, 5: _hard_tanh,
            6: lambda z: z / (1 + z.abs())}


def activation_grad_plain(code: int, z: torch.Tensor,
                          h: torch.Tensor) -> torch.Tensor:
    """``act'(z)`` from ``z`` and ``h = act(z)``, with the JAX package's
    gradient at a tie (relu 0 at 0, leaky relu 1 at 0, hard tanh half on a
    bound)."""
    one, zero = torch.ones_like(z), torch.zeros_like(z)
    if code == 1:
        return 1 - h * h
    if code == 2:
        return torch.where(z > 0, one, zero)
    if code == 3:
        return h * (1 - h)
    if code == 4:
        return torch.where(z >= 0, one, torch.full_like(z, 0.01))
    if code == 5:
        inside = torch.where((z > -1) & (z < 1), one, zero)
        return torch.where((z == 1) | (z == -1), torch.full_like(z, 0.5),
                           inside)
    if code == 6:
        d = 1 + z.abs()
        return 1 / (d * d)
    return one


def cell_fwd_plain(cell: str, gx_t, a_t, h_prev, c_prev=None, b_hh=None,
                   w_peep=None, act: int = 1):
    """One step's cell from ``gx_t`` [B, GU] and ``a_t = h_prev @ W_hh``:
    ``(saved [B, GU], h, c or None, hn or None)``, the saved values those
    the kernel keeps over gx (GRU ``[r, u, c]``, Graves ``[i, f, g, o]``,
    simple RNN the pre-activation)."""
    u = h_prev.shape[1]
    if cell == "gru":
        ar, au, ac = a_t.split(u, dim=-1)
        br, bu, bc = b_hh.split(u)
        gr, gu, gc = gx_t.split(u, dim=-1)
        n = ac + bc
        r = torch.sigmoid(gr + (ar + br))
        uu = torch.sigmoid(gu + (au + bu))
        c = torch.tanh(gc + r * n)
        return torch.cat([r, uu, c], -1), uu * h_prev + (1 - uu) * c, None, n
    if cell == "graves":
        z = gx_t + a_t
        zi, zf, zg, zo = z.split(u, dim=-1)
        i = torch.sigmoid(zi + w_peep[0] * c_prev)
        f = torch.sigmoid(zf + w_peep[1] * c_prev)
        g = torch.tanh(zg)
        c = f * c_prev + i * g
        o = torch.sigmoid(zo + w_peep[2] * c)
        return torch.cat([i, f, g, o], -1), o * torch.tanh(c), c, None
    z = gx_t + a_t
    return z, _ACT_FWD[act](z), None, None


def recurrence_fwd_plain(cell: str, gx, w_hh, h0, c0=None, b_hh=None,
                         w_peep=None, act: int = 1):
    """``(saved, hs, cs, hn)``: the recurrence over ``gx`` [T, B, GU] from
    ``h0`` (and the Graves ``c0``) [B, U], a step ``h_{t-1} @ w_hh`` and the
    plain cell; ``cs`` (Graves) and ``hn`` (GRU) [T, B, U] or None."""
    t_len, bsz, _ = gx.shape
    u = h0.shape[1]
    saved = torch.empty_like(gx)
    hs = gx.new_empty(t_len, bsz, u)
    cs = torch.empty_like(hs) if cell == "graves" else None
    hn = torch.empty_like(hs) if cell == "gru" else None
    h, c = h0, c0
    for t in range(t_len):
        saved[t], h, c_new, n = cell_fwd_plain(cell, gx[t], h @ w_hh, h, c,
                                               b_hh, w_peep, act)
        hs[t] = h
        if cs is not None:
            cs[t] = c = c_new
        if hn is not None:
            hn[t] = n
    return saved, hs, cs, hn


def recurrence_bwd_plain(cell: str, saved, hs, cs, hn, h0, c0, w_hh,
                         w_peep=None, d_hs=None, dh_T=None, dc_T=None,
                         act: int = 1):
    """``(dz, dzh, dh0, dc0)``: the recurrence's gradient in reverse time
    from the forward's saved values, the output gradient ``d_hs`` [T, B,
    U] and ``dh_T``, ``dc_T`` [B, U] (None is zero); ``dzh`` is ``dz``
    but for the GRU; ``dc0`` None but for Graves."""
    t_len, bsz, u = hs.shape
    dz = torch.empty_like(saved)
    dzh = torch.empty_like(saved) if cell == "gru" else dz
    zero = torch.zeros_like(h0)
    carried = dh_T if dh_T is not None else zero
    direct = zero                       # the GRU's dh_{t+1} u_{t+1}
    dc = dc_T if dc_T is not None else zero
    w_t = w_hh.t()
    for t in range(t_len - 1, -1, -1):
        dh = (d_hs[t] if d_hs is not None else zero) + carried
        if cell == "gru":
            dh = dh + direct
            r, uu, c = saved[t].split(u, dim=-1)
            hp = hs[t - 1] if t else h0
            du = dh * (hp - c)
            dcand = dh * (1 - uu) * (1 - c * c)
            dzr = dcand * hn[t] * r * (1 - r)
            dzu = du * uu * (1 - uu)
            dz[t] = torch.cat([dzr, dzu, dcand], -1)
            dzh[t] = torch.cat([dzr, dzu, dcand * r], -1)
            direct = dh * uu
        elif cell == "graves":
            i, f, g, o = saved[t].split(u, dim=-1)
            cp = cs[t - 1] if t else c0
            tc = torch.tanh(cs[t])
            dzo = dh * tc * o * (1 - o)
            dct = dc + dh * o * (1 - tc * tc) + dzo * w_peep[2]
            dzi = dct * g * i * (1 - i)
            dzf = dct * cp * f * (1 - f)
            dz[t] = torch.cat([dzi, dzf, dct * i * (1 - g * g), dzo], -1)
            dc = dct * f + dzi * w_peep[0] + dzf * w_peep[1]
        else:
            dz[t] = dh * activation_grad_plain(act, saved[t], hs[t])
        carried = dzh[t] @ w_t
    dh0 = carried + direct if cell == "gru" else carried
    return dz, dzh, dh0, (dc if cell == "graves" else None)


# ----------------------------------------------------------------------
# the wrappers
def _needs(cell: str, what: str, **ts) -> None:
    for name, t in ts.items():
        if t is None:
            raise ValueError(f"{what}: a {cell} recurrence needs {name}")


def recurrence_fwd(cell: str, gx: torch.Tensor, w_hh: torch.Tensor,
                   h0: torch.Tensor, c0: Optional[torch.Tensor] = None,
                   b_hh: Optional[torch.Tensor] = None,
                   w_peep: Optional[torch.Tensor] = None, act: int = 1):
    """``(saved, hs, cs, hn)`` of :func:`recurrence_fwd_plain`, with ``gx``
    [T, B, GU] overwritten by the saved values (``saved`` is ``gx``). One
    launch on the card, the plain version on the CPU."""
    what = f"{cell}_recurrence_fwd"
    g = GATES[cell]
    if gx.dim() != 3 or gx.shape[2] % g:
        raise ValueError(f"{what}: gx {tuple(gx.shape)} must be [T, B, "
                         f"{g}U]")
    t_len, bsz, gu = gx.shape
    u = gu // g
    if cell == "gru":
        _needs(cell, what, b_hh=b_hh)
    if cell == "graves":
        _needs(cell, what, c0=c0, w_peep=w_peep)
    dev = gx.device
    _check(what, gx.dtype, dev, gx=(gx, (t_len, bsz, gu)),
           w_hh=(w_hh, (u, gu)), h0=(h0, (bsz, u)), c0=(c0, (bsz, u)),
           b_hh=(b_hh, (gu,)), w_peep=(w_peep, (3, u)))
    if dev.type == "cpu":
        saved, hs, cs, hn = recurrence_fwd_plain(cell, gx, w_hh, h0, c0,
                                                 b_hh, w_peep, act)
        gx.copy_(saved)
        return gx, hs, cs, hn
    plan = _card_plan(dev.index, cell, gx.dtype, bsz, u)
    hs = gx.new_empty(t_len, bsz, u)
    cs = torch.empty_like(hs) if cell == "graves" else None
    hn = torch.empty_like(hs) if cell == "gru" else None
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    with torch.cuda.device(dev):
        err = _lib().dl4j_rnn_recurrence_fwd(
            CELLS[cell], gx.data_ptr(), w_hh.data_ptr(), _ptr(b_hh),
            _ptr(w_peep), h0.data_ptr(), _ptr(c0), hs.data_ptr(), _ptr(cs),
            _ptr(hn), t_len, bsz, u, plan.ranks, _tiles(plan), act,
            _DTYPES[gx.dtype], stream)
    _cuda.check(err, "dl4j_rnn_recurrence_fwd")
    LAUNCHES[what] += 1
    return gx, hs, cs, hn


def recurrence_bwd(cell: str, saved: torch.Tensor, hs: torch.Tensor,
                   cs: Optional[torch.Tensor], hn: Optional[torch.Tensor],
                   h0: torch.Tensor, c0: Optional[torch.Tensor],
                   w_hh: torch.Tensor, w_peep: Optional[torch.Tensor] = None,
                   d_hs: Optional[torch.Tensor] = None,
                   dh_T: Optional[torch.Tensor] = None,
                   dc_T: Optional[torch.Tensor] = None, act: int = 1):
    """``(dz, dzh, dh0, dc0)`` of :func:`recurrence_bwd_plain` (``d_hs``,
    ``dh_T`` and ``dc_T`` may be None: zero). One launch on the card, the
    plain version on the CPU."""
    what = f"{cell}_recurrence_bwd"
    g = GATES[cell]
    if saved.dim() != 3 or saved.shape[2] % g:
        raise ValueError(f"{what}: saved {tuple(saved.shape)} must be [T, "
                         f"B, {g}U]")
    t_len, bsz, gu = saved.shape
    u = gu // g
    if cell == "gru":
        _needs(cell, what, hn=hn)
    if cell == "graves":
        _needs(cell, what, cs=cs, c0=c0, w_peep=w_peep)
    dev = saved.device
    _check(what, saved.dtype, dev, saved=(saved, (t_len, bsz, gu)),
           hs=(hs, (t_len, bsz, u)), cs=(cs, (t_len, bsz, u)),
           hn=(hn, (t_len, bsz, u)), h0=(h0, (bsz, u)), c0=(c0, (bsz, u)),
           w_hh=(w_hh, (u, gu)), w_peep=(w_peep, (3, u)),
           d_hs=(d_hs, (t_len, bsz, u)), dh_T=(dh_T, (bsz, u)),
           dc_T=(dc_T, (bsz, u)))
    if dev.type == "cpu":
        return recurrence_bwd_plain(cell, saved, hs, cs, hn, h0, c0, w_hh,
                                    w_peep, d_hs, dh_T, dc_T, act)
    plan = _card_plan(dev.index, cell, saved.dtype, bsz, u)
    dz = torch.empty_like(saved)
    dzh = torch.empty_like(saved) if cell == "gru" else dz
    dh0 = torch.empty_like(h0)
    dc0 = torch.empty_like(h0) if cell == "graves" else None
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    with torch.cuda.device(dev):
        err = _lib().dl4j_rnn_recurrence_bwd(
            CELLS[cell], saved.data_ptr(), hs.data_ptr(), _ptr(cs),
            _ptr(hn), h0.data_ptr(), _ptr(c0), w_hh.data_ptr(), _ptr(w_peep),
            _ptr(d_hs), _ptr(dh_T), _ptr(dc_T), dz.data_ptr(),
            dzh.data_ptr(), dh0.data_ptr(), _ptr(dc0), t_len, bsz, u,
            plan.ranks, _tiles(plan), act, _DTYPES[saved.dtype], stream)
    _cuda.check(err, "dl4j_rnn_recurrence_bwd")
    LAUNCHES[what] += 1
    return dz, dzh, dh0, dc0


# ----------------------------------------------------------------------
# the recurrence
@functools.lru_cache(maxsize=None)
def _cell(cell: str, act: int) -> _sequence.Cell:
    """The ``cell`` recurrence's kernels (the simple RNN's under ``act``)
    as ``_sequence.Sequence`` runs them."""
    def fwd(gx, w_hh, h0, c0, b_hh, w_peep):
        return recurrence_fwd(cell, gx, w_hh, h0, c0, b_hh, w_peep, act)

    def bwd(saved, hs, cs, hn, h0, c0, w_hh, w_peep, d_hs, dh_T, dc_T):
        return recurrence_bwd(cell, saved, hs, cs, hn, h0, c0, w_hh, w_peep,
                              d_hs, dh_T, dc_T, act)
    return _sequence.Cell(cell, GATES[cell], cell == "graves", fwd, bwd)


def recurrence_sequence(cell: str, x, h0, w_ih, w_hh, b, c0=None,
                        b_hh=None, w_peep=None, activation: str = "tanh"):
    """``(hs [B, T, U], hT)`` (Graves: ``(hs, hT, cT)``) of the ``cell``
    recurrence over ``x`` [B, T, I] from ``h0`` (and the Graves ``c0``)
    [B, U], with ``w_ih`` [I, GU], ``w_hh`` [U, GU], ``b`` [GU] (the GRU's
    ``b_ih``), the GRU's ``b_hh`` [GU] and the Graves ``w_peep`` [3, U]
    (``_sequence.Sequence``; ``hs`` a view of the time-major [T, B, U]
    buffer)."""
    if cell not in CELLS:
        raise ValueError(f"unknown recurrence cell {cell!r}")
    act = activation_code(activation) if cell == "simple" else 1
    return _sequence.sequence(_cell(cell, act), x, h0, w_ih, w_hh, b, c0=c0,
                              b_hh=b_hh, w_peep=w_peep)
