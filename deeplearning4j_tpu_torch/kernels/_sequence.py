"""What the cluster recurrence kernels' wrappers share: ``kernels/lstm.py``
(the LSTM) and ``kernels/recurrence.py`` (the GRU, peephole LSTM and
simple RNN), whose kernels are the instantiations of one engine,
``csrc/lstm_recurrence.cu``, over the cell.

- the dtypes the kernels take, the cluster's split of the units over its
  blocks and a block's shared memory on Hopper;
- the launch plan: the engine's shared memory a block for each cell
  (:func:`recurrence_geometry`, the C side's ``RecGeo``), resident or
  streamed, and the batch rows a cluster (:func:`plan`);
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


#: each cell's shape in the engine (``csrc/lstm_recurrence.cu``
#: ``Traits``): gate columns a unit (G), units a group (UG), the backward's
#: stage planes (NI), the forward's output planes (NO), a forward state
#: plane, a backward carried plane, parameter rows kept in shared memory
#: forward and backward, a dz tile beside dzh
CELL_SHAPES: Dict[str, Tuple[int, ...]] = {
    "lstm": (4, 8, 7, 6, 1, 1, 0, 0, 0),
    "graves": (4, 8, 7, 6, 1, 1, 3, 3, 0),
    "gru": (3, 16, 6, 5, 0, 1, 3, 0, 1),
    "simple": (1, 16, 3, 2, 0, 0, 0, 0, 0)}
#: the kernels' warps a block
WARPS = 8


def recurrence_geometry(cell: str, u: int, ranks: int, n_tiles: int,
                        resident: bool, itemsize: int) -> Tuple[int, int]:
    """(forward, backward) shared memory of a block in bytes of the
    engine's ``cell`` kernels: the resident form's ``RecGeo`` for ``u``
    units over ``ranks`` blocks and ``n_tiles`` tiles of 8 batch rows (the
    ``W_hh`` slice, the h tiles, the partial products, the stages and the
    state planes), or the streamed form's partial products (a warp's MT
    m16n8 tiles forward, one backward). A group is UG units and their G UG
    gate columns, MT = G UG / 16 tiles of the product's 16 rows."""
    g, ug, ni, no, state, carry, pf, pb, x = CELL_SHAPES[cell]
    mt = g * ug // 16
    if not resident:
        return WARPS * mt * 4 * 32 * itemsize, WARPS * 4 * 32 * itemsize
    nu = -(-u // ranks)
    ng = -(-nu // ug)
    nc, up, bt = g * ug * ng, -(-u // 16) * 16, 8 * n_tiles
    ldw, ldh, ldg, ldz = nc + 8, up + 4, ug * ng + 4, nc + 4
    kt = up // 8
    ksplit = min(1 if ng >= WARPS else WARPS // ng, kt)
    items = ng * ksplit
    # float32: the slice in mma fragment order; float64: rows of ldw
    w = up * (nc if itemsize == 4 else ldw)
    fwd = (w + 2 * bt * ldh + items * mt * 4 * n_tiles * 32
           + (2 * g + state + no) * bt * ldg + pf * ldg)
    bwd = (w + 2 * ranks * bt * ldg + (1 + x) * bt * ldz
           + (2 * ni + carry) * bt * ldg + pb * ldg)
    return fwd * itemsize, bwd * itemsize


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the kernels split a recurrence of ``b`` rows and ``u`` units."""
    ranks: int          # blocks a cluster (R)
    units: int          # units a block: block k owns [k units, (k+1) units)
    n_tiles: int        # a cluster's batch rows in tiles of 8
    clusters: int       # clusters a launch, each its own rows
    resident: bool      # the W_hh slice in shared memory (else streamed)
    smem_fwd: int       # bytes a block
    smem_bwd: int
    max_clusters: Optional[int]   # the card's at once (None: not asked)

    @property
    def b_tile(self) -> int:
        return 8 * self.n_tiles

    def block_units(self, u: int):
        """Each block's units, a range a block."""
        return [range(k * self.units, min(u, (k + 1) * self.units))
                for k in range(self.ranks)]

    def cluster_rows(self, b: int):
        """Each cluster's batch rows, a range a cluster."""
        return [range(c * self.b_tile, min(b, (c + 1) * self.b_tile))
                for c in range(self.clusters)]


def plan(cell: str, b: int, u: int, itemsize: int, tiles: Tuple[int, ...],
         occupancy: Optional[Callable[[int, int, bool], int]] = None
         ) -> Plan:
    """The plan for a ``cell`` recurrence of ``b`` batch rows and ``u``
    units of ``itemsize`` bytes.

    R and the units a block: :func:`split_units`. The ``W_hh`` slice is
    resident where both directions fit :data:`SMEM_LIMIT` with it at one
    batch tile, else the streamed form (8 rows a cluster) takes any width.
    The resident batch tile, of ``tiles``: the fewest rows a cluster (the
    shortest step) for which the launch's clusters all fit on the card at
    once, ``occupancy(ranks, n_tiles, resident)`` clusters (the card's
    calculator; None: no limit); else the tile with the fewest waves."""
    ranks, units = split_units(u)

    def fits(nt, res):
        return max(recurrence_geometry(cell, u, ranks, nt, res, itemsize)) \
            <= SMEM_LIMIT

    resident = fits(1, True)
    cands = [nt for nt in tiles if fits(nt, True)] if resident else [1]
    clusters = {nt: -(-b // (8 * nt)) for nt in cands}
    limit = {nt: occupancy(ranks, nt, resident) if occupancy else None
             for nt in cands}
    ok = [nt for nt in cands if limit[nt] is None or clusters[nt] <= limit[nt]]
    if ok:
        nt = ok[0]
    else:
        nt = min(cands, key=lambda t: (-(-clusters[t] // max(1, limit[t])),
                                       t))
    fwd, bwd = recurrence_geometry(cell, u, ranks, nt, resident, itemsize)
    return Plan(ranks, units, nt, clusters[nt], resident, fwd, bwd,
                limit[nt])


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
