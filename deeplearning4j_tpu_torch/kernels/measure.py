"""Measuring the port's kernels on the card: device times, the least time
the card could take, and what the compiler made of a built library.

``chip_smoke.py`` and the studies under ``experiments/`` time and inspect
the kernels with these, so that all read a kernel the same way; the case
builders here make the inputs that ``chip_smoke.py`` and the card tests
check with.
Nothing here runs at import: the functions need a card (``median_ms``) or
the CUDA toolkit (``sass_kernels``) only when called.
"""
from __future__ import annotations

import ctypes
import math
import os
import re
import subprocess
import time
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

#: (memory bytes/s, non-tensor-core float32 FLOP/s), from NVIDIA's data
#: sheets, by a word of the card's name
CARDS = {"PCIe": (2.0e12, 51e12), "NVL": (3.9e12, 60e12),
         "H100": (3.35e12, 67e12)}
#: H100 SXM dense bf16 tensor-core rate (FLOP/s)
BF16_TC_FLOPS = 989e12
#: dense bf16 tensor-core rate (FLOP/s) by a word of the card's name, from
#: NVIDIA's data sheets
BF16_TC = {"PCIe": 756e12, "NVL": 835e12, "H100": BF16_TC_FLOPS}
#: dense TF32 tensor-core rate (FLOP/s) by a word of the card's name, from
#: NVIDIA's data sheets; a float32-grade product in 3xTF32 takes three
TF32_TC = {"PCIe": 378e12, "NVL": 417.5e12, "H100": 495e12}
#: the device sleep the host queues timed calls behind (cycles; ~50 ms)
SLEEP_CYCLES = 10**8


def _card_word(name: str) -> str:
    """The word of the card's name the rate tables are keyed by."""
    for key in ("PCIe", "NVL", "H100"):
        if key in name:
            return key
    raise SystemExit(f"no rates on record for {name!r}")


def card_rates(name: str) -> Tuple[float, float]:
    """(memory bytes/s, float32 FLOP/s) of the card named ``name``."""
    return CARDS[_card_word(name)]


def tf32x3_rate(name: str) -> float:
    """FLOP/s of float32-grade products in 3xTF32 on the card named
    ``name``: its dense TF32 tensor-core rate over 3."""
    return TF32_TC[_card_word(name)] / 3


def two_rate_bound(ops: float, nbytes: float, name: str) -> Dict[str, object]:
    """The least time (ms) of ``ops`` float32-grade operations on
    ``nbytes`` bytes on the card named ``name``: the bytes over its memory
    rate, the operations over its float32 FMA rate and over its 3xTF32
    rate; the bound is the larger of the bytes' and the 3xTF32 time (the
    tensor cores compute float32-grade products faster than the FMA
    units)."""
    bw, flops32 = card_rates(name)
    by_bytes = 1e3 * nbytes / bw
    fma = 1e3 * ops / flops32
    tc = 1e3 * ops / tf32x3_rate(name)
    return {"bytes_ms": by_bytes, "fma_ms": fma, "tf32x3_ms": tc,
            "bound_ms": max(by_bytes, tc),
            "bound_by": "bytes" if by_bytes >= tc else "operations"}


def int8_weight_bound(ops: float, nbytes: float,
                      name: str) -> Dict[str, object]:
    """The least time (ms) of ``ops`` float32-grade operations of a float32
    x with an int8 weight on ``nbytes`` bytes on the card named ``name``.
    An int8 value is exact in TF32 and in bf16, so only x is split: x_hi w
    + x_lo w is two TF32 passes (``tf32x2_ms``), and x cut into three bf16
    pieces (24 significant bits, float32's exponent range) is three bf16
    passes (``bf16x3_ms``); the bound is the larger of the bytes' time and
    the faster of the two (the FMA rate's time beside them)."""
    bw, flops32 = card_rates(name)
    word = _card_word(name)
    by_bytes = 1e3 * nbytes / bw
    tf32x2 = 1e3 * ops / (TF32_TC[word] / 2)
    bf16x3 = 1e3 * ops / (BF16_TC[word] / 3)
    tc = min(tf32x2, bf16x3)
    return {"bytes_ms": by_bytes, "fma_ms": 1e3 * ops / flops32,
            "tf32x2_ms": tf32x2, "bf16x3_ms": bf16x3, "ops_ms": tc,
            "bound_ms": max(by_bytes, tc),
            "bound_by": "bytes" if by_bytes >= tc else "operations"}


def lstm_recurrence_cost(b: int, t: int, u: int, itemsize: int
                         ) -> Dict[str, Tuple[int, int]]:
    """(operations, bytes) each LSTM recurrence kernel
    (``csrc/lstm_recurrence.cu``) must spend on ``b`` rows of ``u`` units
    over ``t`` steps: the forward reads W_hh [u, 4u] once, gx [t, b, 4u],
    h0 and c0, and writes the gates [t, b, 4u], hs and cs [t, b, u]; the
    backward reads W_hh, the gates, cs, c0, d_hs, dh_T and
    dc_T, and writes dz [t, b, 4u], dh0 and dc0. Operations: the step's
    product (2 b u 4u a step, h @ W_hh or dz @ W_hh^T) and the cell's (a
    unit: the forward's 3 sigmoids of 3, 2 tanh and 4 products and sums,
    15; the backward's tanh, 2 sums and 20 products and differences,
    23), each exp, tanh and division counted as one."""
    n, w = b * u, 4 * u * u
    prod = 2 * b * u * 4 * u * t
    fwd = (w + 4 * n * t + 2 * n + 4 * n * t + 2 * n * t) * itemsize
    bwd = (w + 4 * n * t + n * t + n + n * t + 2 * n + 4 * n * t + 2 * n) \
        * itemsize
    return {"lstm_recurrence_fwd": (prod + 15 * n * t, fwd),
            "lstm_recurrence_bwd": (prod + 23 * n * t, bwd)}


def lstm_recurrence_case(b: int, t: int, u: int, dtype, dev, seed: int = 0):
    """Seeded inputs of one layer's recurrence kernels: gx [T, B, 4U] (as
    ``x @ W_ih + b``, scale 2), W_hh [U, 4U] over sqrt(U) (an initialised
    layer's scale), h0, c0 [B, U], d_hs [T, B, U], dh_T and dc_T [B, U]."""
    g = torch.Generator().manual_seed(seed)
    gx = 2 * torch.randn(t, b, 4 * u, generator=g, dtype=dtype)
    w = torch.randn(u, 4 * u, generator=g, dtype=dtype) / math.sqrt(u)
    rest = [torch.randn(*s, generator=g, dtype=dtype)
            for s in ((b, u), (b, u), (t, b, u), (b, u), (b, u))]
    return [x.to(dev) for x in [gx, w] + rest]


def rnn_recurrence_cost(cell: str, b: int, t: int, u: int, itemsize: int
                        ) -> Dict[str, Tuple[int, int]]:
    """(operations, bytes) each recurrence kernel of
    ``csrc/lstm_recurrence.cu``'s GRU, Graves and simple RNN cells must
    spend on ``b`` rows of ``u`` units over
    ``t`` steps, G gate columns a unit (GRU 3, Graves 4, simple 1). The
    forward reads W_hh [u, Gu] once, gx [t, b, Gu] and h0 (Graves c0,
    the peepholes; GRU b_hh) and writes the saved values [t, b, Gu] and hs
    (Graves cs, GRU hn) [t, b, u]; the backward reads W_hh, the saved
    values, hs, the extra state, h0, d_hs and dh_T, and writes dz (GRU dzh
    too) [t, b, Gu] and dh0 (Graves dc0). Operations: the step's product
    (2 b u Gu a step) and the cell's (a unit and step: GRU 20 forward, 25
    backward; Graves 25 and 30; simple 2 and 3), each exp, tanh and
    division counted as one."""
    g = {"gru": 3, "graves": 4, "simple": 1}[cell]
    n, w = b * u, g * u * u
    prod = 2 * b * u * g * u * t
    extra = 0 if cell == "simple" else n * t          # cs or hn
    state = n * (2 if cell == "graves" else 1)        # h0 (and c0)
    fwd = (w + g * n * t + state + g * n * t + n * t + extra) * itemsize
    outs = g * n * t * (2 if cell == "gru" else 1) + state
    bwd = (w + g * n * t + n * t + extra + state + n * t + n + outs) \
        * itemsize
    cell_ops = {"gru": (20, 25), "graves": (25, 30), "simple": (2, 3)}[cell]
    return {f"{cell}_recurrence_fwd": (prod + cell_ops[0] * n * t, fwd),
            f"{cell}_recurrence_bwd": (prod + cell_ops[1] * n * t, bwd)}


def rnn_recurrence_case(cell: str, b: int, t: int, u: int, dtype, dev,
                        seed: int = 0, act: int = 1):
    """Seeded inputs of one layer's ``cell`` recurrence kernels and their
    plain forward: a dict of gx [T, B, GU] (scale 2), W_hh [U, GU] over
    sqrt(U), h0 (Graves c0 and the peepholes [3, U] at 0.3; GRU b_hh),
    d_hs [T, B, U], dh_T (Graves dc_T) [B, U], and the forward's saved
    values, hs, cs and hn from ``recurrence_fwd_plain``."""
    from deeplearning4j_tpu_torch.kernels import recurrence
    g = torch.Generator().manual_seed(seed)
    gates = recurrence.GATES[cell]

    def r(*s, scale=1.0):
        return (scale * torch.randn(*s, generator=g, dtype=dtype)).to(dev)
    case = {"gx": r(t, b, gates * u, scale=2.0),
            "w_hh": r(u, gates * u, scale=1 / math.sqrt(u)),
            "h0": r(b, u), "d_hs": r(t, b, u), "dh_T": r(b, u),
            "c0": None, "b_hh": None, "w_peep": None, "dc_T": None,
            "act": act}
    if cell == "graves":
        case.update(c0=r(b, u), w_peep=r(3, u, scale=0.3), dc_T=r(b, u))
    if cell == "gru":
        case["b_hh"] = r(gates * u, scale=0.5)
    saved, hs, cs, hn = recurrence.recurrence_fwd_plain(
        cell, case["gx"], case["w_hh"], case["h0"], case["c0"],
        case["b_hh"], case["w_peep"], act)
    case.update(saved=saved, hs=hs, cs=cs, hn=hn)
    return case


def rnn_fwd_args(case):
    """``recurrence_fwd``'s arguments but gx, from a case."""
    return (case["w_hh"], case["h0"], case["c0"], case["b_hh"],
            case["w_peep"], case["act"])


def rnn_bwd_args(case):
    """``recurrence_bwd``'s arguments but the cell, from a case."""
    return (case["saved"], case["hs"], case["cs"], case["hn"], case["h0"],
            case["c0"], case["w_hh"], case["w_peep"], case["d_hs"],
            case["dh_T"], case["dc_T"], case["act"])


def median_ms(fn: Callable[[], object], flush: torch.Tensor,
              iters: int = 20) -> float:
    """Median device time of ``fn`` over ``iters`` calls, each after
    ``flush`` was overwritten (a 1 GiB buffer evicts L2: the main path
    finds its inputs cold). The host queues every call behind a device
    sleep and checks that the sleep outlasted its queueing, so no host
    time enters the events (``torch.autograd.grad``'s did, behind the
    write alone); the sleep is doubled until it does."""
    fn()
    torch.cuda.synchronize()
    cycles = SLEEP_CYCLES
    for _ in range(4):
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        asleep = torch.cuda.Event()
        torch.cuda._sleep(cycles)
        asleep.record()
        for s, e in ev:
            flush.zero_()
            s.record()
            fn()
            e.record()
        covered = not asleep.query()
        torch.cuda.synchronize()
        if covered:
            return float(np.median([s.elapsed_time(e) for s, e in ev]))
        cycles *= 2
    raise SystemExit("the host did not finish queueing within the sleep")


def queued_ms(fn: Callable[[], object], flush: torch.Tensor,
              iters: int = 10) -> float:
    """Median device time of ``fn`` over ``iters`` calls, each queued
    alone behind a device sleep, for a function of many launches:
    ``median_ms`` queues all its calls behind one sleep, and past the
    launch queue's depth the host waits on the device, so the sleep never
    covers the queueing. The sleep is doubled until it outlasts one call's
    queueing."""
    fn()
    torch.cuda.synchronize()
    cycles = SLEEP_CYCLES // 10
    out = []
    while len(out) < iters:
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        asleep = torch.cuda.Event()
        flush.zero_()
        torch.cuda._sleep(cycles)
        asleep.record()
        s.record()
        fn()
        e.record()
        covered = not asleep.query()
        torch.cuda.synchronize()
        if covered:
            out.append(s.elapsed_time(e))
        elif cycles >= 8 * SLEEP_CYCLES:
            raise SystemExit("the host did not finish queueing a call "
                             "within the sleep")
        else:
            cycles *= 2
    return float(np.median(out))


def synced_ms(fn: Callable[[], object], flush: torch.Tensor,
              iters: int = 3) -> float:
    """Median wall time of ``fn`` between two synchronizations, each call
    after ``flush`` was overwritten: for a function that waits on the
    device itself (``paged_attention_plain`` reads its lanes to the
    host), which ``median_ms`` cannot queue behind a device sleep. Host
    time is in it."""
    fn()
    out = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(out))


def sass_kernels(lib_path: str) -> Dict[str, str]:
    """The SASS of each kernel in a built library, by (mangled) name, from
    the toolkit's ``cuobjdump -sass``."""
    from deeplearning4j_tpu_torch.kernels import _cuda
    tool = os.path.join(os.path.dirname(_cuda.nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    kernels = {}
    for part in out.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        kernels[name.strip()] = body
    return kernels


def sass_counts(body: str) -> Tuple[int, int, int]:
    """(HGMMA, UTMALDG, WARPGROUP.DEPBAR) instructions in one kernel's
    SASS: a wgmma batch that ptxas serialized shows one DEPBAR per
    HGMMA."""
    return (body.count("HGMMA."), body.count("UTMALDG"),
            body.count("WARPGROUP.DEPBAR"))


def ptxas_spills(log: str) -> Dict[str, Tuple[int, int]]:
    """(spill stores, spill loads) in bytes per kernel (mangled name), from
    ``nvcc -Xptxas -v``'s report."""
    spills, fn = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            fn = line.split()[-1]
        elif fn and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            spills[fn] = (nums[1], nums[2])
            fn = None
    return spills


def ptxas_usage(log: str) -> Dict[str, Tuple[int, int]]:
    """(registers a thread, static shared memory bytes) per kernel (mangled
    name), from ``nvcc -Xptxas -v``'s report."""
    use, fn = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            fn = line.split()[-1]
        elif fn and "registers" in line:
            regs = int(line.split("Used")[1].split("registers")[0])
            smem = re.search(r"(\d+) bytes smem", line)
            use[fn] = (regs, int(smem.group(1)) if smem else 0)
            fn = None
    return use


def attention_inputs(dev, b, h, sq, sk, d, dtype, split, seed=0):
    """q, k, v and dO on ``dev``; with ``split`` q, k and v are the views
    build_gpt hands the op (one [B, S, H, 3D] tensor, permuted, split)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if split:
        qkv = torch.randn(b, sq, h, 3 * d, device=dev, generator=g).to(
            dtype).permute(0, 2, 1, 3)
        q, k, v = torch.split(qkv, d, dim=3)
    else:
        q, k, v = (torch.randn(b, h, s, d, device=dev, generator=g).to(dtype)
                   for s in (sq, sk, sk))
    do = torch.randn(b, h, sq, d, device=dev, generator=g).to(dtype)
    return q, k, v, do


def attention_bounds(b, h, sq, sk, d, causal):
    """Per call, (operations, bytes) each attention kernel must do and
    move: the products over the score entries the causal mask leaves (2
    FLOP per multiply-add; forward QK^T and PV, dk/dv S^T, dP^T, P^T dO
    and dS^T q, dq S, dP and dS k) and every input read once, every output
    written once (bf16 tensors, float32 stats and delta)."""
    off = sk - sq
    vis = sum(min(sk, max(0, i + off + 1)) if i + off >= 0 else sk
              for i in range(sq)) if causal else sq * sk
    ent = b * h * vis
    t = 2 * b * h * d                      # bytes per row of a bf16 tensor
    rows_q, rows_k = sq, sk
    return {
        "attention_fwd": (4 * d * ent, t * (rows_q + 2 * rows_k + rows_q)
                          + b * h * sq * 8),
        "attention_bwd_delta": (2 * d * b * h * sq,
                                t * 2 * rows_q + b * h * sq * 4),
        "attention_bwd_dkdv": (8 * d * ent,
                               t * (2 * rows_q + 2 * rows_k + 2 * rows_k)
                               + b * h * sq * 12),
        "attention_bwd_dq": (6 * d * ent,
                             t * (3 * rows_q + 2 * rows_k) + b * h * sq * 12),
    }


def attention_f32_bounds(b, h, sq, sk, d, causal):
    """(operations, bytes) of one float32 attention forward: the products
    over the score entries the causal mask leaves (4 D FLOP an entry, QK^T
    and PV), q, k, v read and O written once at 4 bytes, the stats at 8
    bytes a row."""
    ops, _ = attention_bounds(b, h, sq, sk, d, causal)["attention_fwd"]
    return ops, 4 * b * h * d * (2 * sq + 2 * sk) + 8 * b * h * sq


def tensor_map_encode_us(tensors: Sequence[torch.Tensor], rows: int,
                         reps: int = 1000) -> float:
    """Host microseconds to encode one TMA tensor map for each bf16
    [B, H, S, D] tensor in ``tensors``, as the attention library does at
    every launch (``cuTensorMapEncodeTiled``: dims (D, S, H, B) at the
    tensor's strides, boxes of ``rows`` rows by one column block of up to
    128 bytes, swizzled at its width), called through ctypes from libcuda:
    an upper bound, since ctypes' own cost of each call is in it."""
    cuda = ctypes.CDLL("libcuda.so.1")
    enc = cuda.cuTensorMapEncodeTiled
    u64, u32 = ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint32)
    enc.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                    ctypes.c_void_p, u64, u64, u32, u32, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int]
    enc.restype = ctypes.c_int
    buf = ctypes.create_string_buffer(128 + 64)     # a CUtensorMap: 128 B
    addr = (ctypes.addressof(buf) + 63) & ~63       # on 64 bytes
    calls = []
    for t in tensors:
        b, h, s, d = t.shape
        rb = min(128, 2 * d)                        # the box's row, bytes
        swizzle = {32: 1, 64: 2, 128: 3}[rb]        # CU_TENSOR_MAP_SWIZZLE_*
        calls.append([
            addr, 9, 4, t.data_ptr(),               # BFLOAT16, rank 4
            (ctypes.c_uint64 * 4)(d, s, h, b),
            (ctypes.c_uint64 * 3)(*(2 * t.stride(i) for i in (2, 1, 0))),
            (ctypes.c_uint32 * 4)(rb // 2, rows, 1, 1),
            (ctypes.c_uint32 * 4)(1, 1, 1, 1),
            0, swizzle, 3, 0])                      # L2 promotion 256 B
    for c in calls:
        if enc(*c) != 0:
            raise RuntimeError(f"cuTensorMapEncodeTiled refused {c}")
    t0 = time.perf_counter()
    for _ in range(reps):
        for c in calls:
            enc(*c)
    return 1e6 * (time.perf_counter() - t0) / reps


# ----------------------------------------------------------------------
# paged attention (kernels/paged_attention.py)
def _qkv_views(rows, a, d, dtype, dev, g):
    """q, k and v [rows, A, D] as the serving path hands them over: the
    thirds of each head's ``[q|k|v]`` block of one [rows, A, 3D]
    projection."""
    qkv = torch.randn(rows, a, 3 * d, device=dev, generator=g).to(dtype)
    return qkv.split(d, dim=-1)


def paged_decode_case(dev, kmax, a, d, bs, dtype, seed=0, spare=2):
    """A decode step's inputs: lane ``s`` (one query row) has last key
    ``kmax[s]`` and holds blocks ``1 + sum of the earlier lanes' blocks``
    onward, in order; block 0 (null) and ``spare`` blocks past them are
    unused. Returns (q, kc, vc, tables, lane, kmax), every block finite."""
    g = torch.Generator(device=dev).manual_seed(seed)
    kmax = [int(k) for k in kmax]
    nblk = [k // bs + 1 for k in kmax]
    maxb = max(nblk)
    nb = 1 + sum(nblk) + spare
    kc, vc = (torch.randn(nb, a, bs, d, device=dev, generator=g).to(dtype)
              for _ in range(2))
    tables = torch.zeros(len(kmax), maxb, dtype=torch.int32)
    base = 1
    for s, n in enumerate(nblk):
        tables[s, :n] = torch.arange(base, base + n, dtype=torch.int32)
        base += n
    s = len(kmax)
    return (_qkv_views(s, a, d, dtype, dev, g)[0], kc, vc, tables.to(dev),
            torch.arange(s, dtype=torch.int32, device=dev),
            torch.tensor(kmax, dtype=torch.int32, device=dev))


def paged_prefill_case(dev, hist, rows, length, a, d, bs, dtype, seed=0,
                       spare=2):
    """A prefill's inputs: one lane whose blocks hold ``hist + length``
    keys (blocks 1, 2, ... in order), ``rows`` query rows, row ``j``'s
    last key ``hist + min(j, length - 1)`` (a padded row stops at the last
    real one, as the serving path hands it over)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n = (hist + length - 1) // bs + 1
    maxb = n + 1
    kc, vc = (torch.randn(1 + n + spare, a, bs, d, device=dev,
                          generator=g).to(dtype) for _ in range(2))
    tables = torch.zeros(1, maxb, dtype=torch.int32)
    tables[0, :n] = torch.arange(1, n + 1, dtype=torch.int32)
    kmax = hist + torch.clamp(torch.arange(rows), max=length - 1)
    return (_qkv_views(rows, a, d, dtype, dev, g)[0], kc, vc, tables.to(dev),
            torch.zeros(rows, dtype=torch.int32, device=dev),
            kmax.to(torch.int32).to(dev))


def paged_decode_write_case(dev, kmax, a, d, bs, dtype, active=None,
                            seed=0, spare=2):
    """A decode step's inputs with its K/V write: ``paged_decode_case``'s
    (q, kc, vc, tables, lane, kmax) and the step's new rows k_new, v_new
    (the other thirds of q's projection), each active lane writing at its
    last key's place through its table (``write_block`` -1 and
    ``write_off`` 0 for an inactive lane, which attends to key 0). Returns
    (q, k_new, v_new, kc, vc, tables, lane, kmax, write_block,
    write_off)."""
    q, kc, vc, tables, lane, km = paged_decode_case(dev, kmax, a, d, bs,
                                                    dtype, seed, spare)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    q, k_new, v_new = _qkv_views(q.shape[0], a, d, dtype, dev, g)
    act = torch.ones(q.shape[0], dtype=torch.bool) if active is None else \
        torch.tensor(active, dtype=torch.bool)
    kh = km.cpu().long()
    wb = torch.where(act, tables.cpu()[torch.arange(len(kh)), kh // bs], -1)
    wo = torch.where(act, kh % bs, 0)
    km = torch.where(act, kh, 0)
    i32 = dict(dtype=torch.int32, device=dev)
    return (q, k_new, v_new, kc, vc, tables, lane, km.to(**i32),
            wb.to(**i32), wo.to(**i32))


def paged_write_poisoned(kc, vc, write_block, write_off):
    """Copies of the cache with NaN at every row the step writes: the
    kernel takes the step's rows as those keys and never reads them back,
    so what was there changes nothing."""
    kc, vc = kc.clone(), vc.clone()
    for b, o in zip(write_block.tolist(), write_off.tolist()):
        if b >= 0:
            kc[b, :, o] = vc[b, :, o] = float("nan")
    return kc, vc


def paged_chunk_dropped(q, kc, vc, tables, lane, kmax, chunk, size=16):
    """The attention of ``paged_attention_plain`` with key positions
    ``[chunk * size, (chunk + 1) * size)`` of every row left out: what a
    kernel that lost one chunk would give (a control the rule must
    reject), computed as a dense softmax over each row's gathered keys."""
    n, a, d = q.shape
    dk, dv, _ = paged_dense(kc, vc, tables)
    t = torch.arange(dk.shape[2], device=q.device)
    keep = (t[None, :] <= kmax.long()[:, None]) & ~(
        (t >= chunk * size) & (t < (chunk + 1) * size))[None, :]
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    ln = lane.long()
    s = torch.einsum("rad,ratd->rat", q.to(acc), dk[ln].to(acc)) / math.sqrt(d)
    s = torch.where(keep[:, None, :], s, float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)
    v = torch.where(keep[:, None, :, None], dv[ln].to(acc), 0)
    return torch.einsum("rat,ratd->rad", p, v).to(q.dtype)


def paged_poisoned(kc, vc, tables, lane, kmax):
    """Copies of the cache with NaN wherever no row may read: the null
    block, every block no table uses, and each lane's rows past its last
    key."""
    kc, vc = kc.clone(), vc.clone()
    bs = kc.shape[2]
    last = {}
    for ln, k in zip(lane.tolist(), kmax.tolist()):
        last[ln] = max(last.get(ln, -1), k)
    used = set()
    for ln, k in last.items():
        for u in range(k // bs + 1):
            b = int(tables[ln, u])
            used.add(b)
            lo = k - u * bs + 1
            if lo < bs:
                kc[b, :, lo:] = float("nan")
                vc[b, :, lo:] = float("nan")
    for b in range(kc.shape[0]):
        if b not in used:
            kc[b] = vc[b] = float("nan")
    return kc, vc


def paged_dense(kc, vc, tables):
    """The same contexts as a dense slab [S, A, T, D] (T = MAXB * BS, the
    lane's table gathered in order) and its tables ``[[0], [1], ...]``:
    what the dense decode hands the kernel."""
    s, maxb = tables.shape
    nb, a, bs, d = kc.shape
    g = tables.long()
    dk, dv = (x[g].transpose(1, 2).reshape(s, a, maxb * bs, d).contiguous()
              for x in (kc, vc))
    return dk, dv, torch.arange(s, dtype=torch.int32,
                                device=kc.device)[:, None].contiguous()


def paged_prefill_at_chunk(q, kc, vc, table, kmax, chunk: int):
    """The float32 paged prefill kernel called at an explicit work-item
    size (``chunk`` keys, a multiple of ``attention_f32.CHUNK_ALIGN``):
    another split of what ``paged_prefill_attention`` computes, for
    checks. q, kc, vc on the card with rows on 16 bytes; not counted in
    ``attention_f32.LAUNCHES``."""
    from deeplearning4j_tpu_torch.kernels import attention_f32 as af
    n, a, d = q.shape
    reach = kc.shape[2] * table.shape[0]
    out = torch.empty((n, a, d), dtype=torch.float32, device=q.device)
    part = torch.empty(max(af.partial_floats(a, n, reach, chunk, d), 1),
                       dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        af.launch_prefill(q, kc, vc, table, kmax, out, part,
                          1.0 / math.sqrt(d), chunk,
                          torch.cuda.current_stream(q.device).cuda_stream)
    return out


def paged_reading(got, want, terms, tol):
    """max |got - want| / (tol * terms): the rule holds at <= 1; NaN reads
    as a failure (inf)."""
    err = (got.double() - want.double()).abs() / (tol * terms + 1e-300)
    r = float(err.max())
    return r if np.isfinite(r) else float("inf")


def paged_bounds(q, kc, tables, lane, kmax, writes=0, win0=None):
    """(operations, bytes) of one call: 4 D FLOP per (row, head, key) for
    q.K and p.V; the K and V rows up to each lane's last key read once at
    the cache's itemsize (a verify's, ``win0`` given: the keys below each
    row's window, the window's own taken from the new rows; a row without
    one, -1, reads to its last key), q read and the output written once;
    for each of ``writes`` rows that write, its new K and V rows read once
    (q's itemsize) and written once (the cache's); an int8 cache's two
    [A, D] float32 scales read once."""
    n, a, d = q.shape
    it, ci = q.element_size(), kc.element_size()
    lanes = {}
    w0s = win0.tolist() if win0 is not None else [-1] * n
    for ln, k, w0 in zip(lane.tolist(), kmax.tolist(), w0s):
        lanes[ln] = max(lanes.get(ln, 0), w0 if w0 >= 0 else k + 1)
    keys = int((kmax.long() + 1).sum())
    kv = sum(lanes.values()) * a * d * ci * 2
    scales = 2 * a * d * 4 if kc.dtype == torch.int8 else 0
    return 4 * d * a * keys, (kv + 2 * n * a * d * it
                              + 2 * writes * a * d * (it + ci) + scales)


def paged_verify_case(dev, pos0, w, a, d, bs, dtype, active=None, seed=0,
                      spare=2, dense=False):
    """A verify's inputs: lane ``s`` holds positions ``0 .. pos0[s] + w -
    1`` in blocks ``1 + the earlier lanes' blocks`` onward (``dense``: one
    block of ``bs`` positions a lane, the slab of the dense verify, lane
    ``s`` in block ``s``); ``w`` window rows a lane (row ``s w + j``), row
    ``j`` writing at position ``pos0[s] + j`` through its table and
    attending to keys ``<= pos0[s] + j``, its window keys from the new
    rows; an inactive lane writes nothing and attends to key 0. Every
    block finite. Returns (q, k_new, v_new, kc, vc, tables, lane, kmax,
    win0, wrow, write_block, write_off)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    s_n = len(pos0)
    act = [True] * s_n if active is None else list(active)
    if dense:
        nblk, nb = [1] * s_n, s_n
        tables = torch.arange(s_n, dtype=torch.int32)[:, None]
    else:
        nblk = [(p + w - 1) // bs + 1 for p in pos0]
        nb = 1 + sum(nblk) + spare
        tables = torch.zeros(s_n, max(nblk), dtype=torch.int32)
        base = 1
        for s, n in enumerate(nblk):
            tables[s, :n] = torch.arange(base, base + n, dtype=torch.int32)
            base += n
    kc, vc = (torch.randn(nb, a, bs, d, device=dev, generator=g).to(dtype)
              for _ in range(2))
    q, k_new, v_new = _qkv_views(s_n * w, a, d, dtype, dev, g)
    lane, kmax, win0, wrow, wb, wo = ([] for _ in range(6))
    for s in range(s_n):
        for j in range(w):
            t = pos0[s] + j
            lane.append(s)
            kmax.append(t if act[s] else 0)
            win0.append(pos0[s] if act[s] else -1)
            wrow.append(s * w)
            wb.append(int(tables[s, t // bs]) if act[s] else -1)
            wo.append(t % bs if act[s] else 0)
    i32 = dict(dtype=torch.int32, device=dev)
    return (q, k_new, v_new, kc, vc, tables.to(dev),
            *(torch.tensor(x, **i32) for x in (lane, kmax, win0, wrow, wb,
                                               wo)))


def int8_cache(kc, vc):
    """An int8 copy of a float cache with per-(head, channel) absmax scales
    over its rows: ``(kc8, vc8, k_scale, v_scale)``, the scales [A, D]
    float32, the payloads ``paged_attention.q_store``'s. The serving path
    calibrates its scales on prompts (``gpt_kv_scales``); the kernels take
    any."""
    from deeplearning4j_tpu_torch.evaluation.calibration import absmax_scales
    from deeplearning4j_tpu_torch.kernels.paged_attention import q_store
    out = []
    for c in (kc, vc):
        a, d = c.shape[1], c.shape[3]
        s = absmax_scales(c.float().transpose(1, 2).reshape(-1, a * d))
        s = s.view(a, d).contiguous()
        out.append((q_store(c, s[:, None, :]), s))
    return out[0][0], out[1][0], out[0][1], out[1][1]


def int8_write_poisoned(kc8, vc8, write_block, write_off):
    """Copies of an int8 cache with -128 (a value no store makes) at every
    row the step writes: the kernel takes the step's stored rows as those
    keys and never reads them back, so what was there changes nothing."""
    kc8, vc8 = kc8.clone(), vc8.clone()
    for b, o in zip(write_block.tolist(), write_off.tolist()):
        if b >= 0:
            kc8[b, :, o] = vc8[b, :, o] = -128
    return kc8, vc8


def paged_int8_library(q, kc8, vc8, k_scale, v_scale, tables, kmax):
    """The library yardstick of an int8 decode: a callable that
    dequantises each lane's context (gathered through its table once,
    outside the call, as an int8 [S, A, T, D] slab) and runs one masked
    ``F.scaled_dot_product_attention`` over it (three PyTorch calls: no
    one call computes attention over an int8 cache)."""
    import torch.nn.functional as F
    dk, dv, _ = paged_dense(kc8, vc8, tables)
    keys = torch.arange(dk.shape[2], device=q.device)
    mask = (keys[None, :] <= kmax[:, None].long())[:, None, None, :]
    ql = q.contiguous()[:, :, None, :]
    ks, vs = k_scale[None, :, None, :], v_scale[None, :, None, :]
    return lambda: F.scaled_dot_product_attention(
        ql, (dk.float() * ks).to(q.dtype), (dv.float() * vs).to(q.dtype),
        attn_mask=mask)


def paged_verify_library(q, kc, vc, tables, lane, kmax, s_n, w):
    """The library yardstick's inputs for a verify of ``s_n`` lanes of
    ``w`` rows: the window's queries [S, A, W, D], each lane's context as
    contiguous [S, A, T, D] K and V (gathered through its table once,
    outside the timing) and the [S, 1, W, T] mask of each row's keys: one
    masked ``F.scaled_dot_product_attention`` computes the attention."""
    dk, dv, _ = paged_dense(kc, vc, tables)
    t = dk.shape[2]
    km = kmax.long().view(s_n, w)
    mask = torch.arange(t, device=q.device)[None, None, :] <= km[:, :, None]
    qs = q.reshape(s_n, w, *q.shape[1:]).transpose(1, 2).contiguous()
    return qs, dk, dv, mask[:, None]


def int8_matmul_case(dev, m, k, n, transposed=False, seed=0):
    """x [m, k] float32 (a GPT activation's scale) and the int8 payload and
    float32 scale ``gpt_quantize_params`` makes of a N(0, 0.02) weight:
    w [k, n] with scale [n], or (``transposed``) w [n, k] with scale [k],
    the tied embedding's layout."""
    from deeplearning4j_tpu_torch.evaluation.calibration import (
        absmax_scales, quantize_symmetric)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m, k, device=dev, generator=g)
    w = torch.randn(n, k, device=dev, generator=g) * 0.02
    if not transposed:
        w = w.t().contiguous()
    s = absmax_scales(w)
    return x, quantize_symmetric(w, s), s


def int8_matmul_bounds(m, k, n):
    """(operations, bytes) of one call: 2 M N K FLOP; the int8 payload,
    x, the scale and y each moved once."""
    return 2 * m * n * k, k * n + 4 * (m * k + m * n + max(k, n))


def set_running_stats(net, x) -> None:
    """Set every batch norm's running statistics of the ComputationGraph
    ``net`` to the batch statistics of ``x`` (NCHW; one training-mode
    forward at decay 0), so that its outputs depend on its input as a
    trained network's do: the zoo's ResNet-50 at init saturates its
    softmax on one class for every input. A case builder for comparisons
    of served outputs (``chip_smoke.py`` phase 25 and the serving
    tests)."""
    from deeplearning4j_tpu_torch.nn.layers import BatchNorm
    bns = [m for m in net.model.modules() if isinstance(m, BatchNorm)]
    decays = [m.decay for m in bns]
    for m in bns:
        m.decay = 0.0
    dtype = next(net.model.parameters()).dtype
    net.model.train()
    with torch.no_grad():
        net.model(torch.as_tensor(x, dtype=dtype, device=net.device)
                  .contiguous(memory_format=torch.channels_last))
    for m, d in zip(bns, decays):
        m.decay = d
    net.model.eval()


def forward_macs(net, hw: int) -> Dict[str, int]:
    """Multiply-adds of one ``hw`` x ``hw`` image's forward through the
    ComputationGraph ``net``, from the shapes the code runs: every
    convolution (N * Ho * Wo * Cout * Cin * kh * kw, read off its weight
    and its output) and every dense layer (in * out), hooked on one
    forward; the batch norms, ReLUs, pools and adds are elementwise and
    not counted."""
    from deeplearning4j_tpu_torch.nn.layers import Affine, Conv2d
    macs = {"conv": 0, "dense": 0}

    def conv(m, inp, out):
        cout, cin, kh, kw = m.W.shape
        n, _, ho, wo = out.shape
        macs["conv"] += n * ho * wo * cout * cin * kh * kw

    def dense(m, inp, out):
        macs["dense"] += inp[0].shape[0] * m.W.shape[0] * m.W.shape[1]
    hooks = [m.register_forward_hook(conv if isinstance(m, Conv2d)
                                     else dense)
             for m in net.model.modules() if isinstance(m, (Conv2d, Affine))]
    try:
        with torch.inference_mode():
            net.model.eval()
            net.model(torch.zeros(1, 3, hw, hw, device=net.device)
                      .contiguous(memory_format=torch.channels_last))
    finally:
        for h in hooks:
            h.remove()
    return macs
