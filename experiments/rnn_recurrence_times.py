"""The recurrence engine's GRU, Graves and simple RNN kernels against their
plain versions (``chip_smoke.py`` phase 29 gate (i)), then each cell
alone at its path's shape beside the LSTM's, and the Gaussian noise draw.

    python3 experiments/rnn_recurrence_times.py [--parent DIR] [--no-gate]

Each kernel is timed alone (``median_ms``: L2 cold, the median of 20
calls queued behind a device sleep), forward and backward: the GRU and
Graves at the sentiment graph's (64, 256, 256), the simple RNN and the
LSTM at the TBPTT chunk's (32, 50, 256), float32; one streamed width,
the GRU at (64, 50, 512); the noise kernel's ``gaussian_noise`` at (64,
256, 300) beside ``torch.normal(x, 0.1)``.

With ``--parent DIR`` (DIR holds ``deeplearning4j_tpu_torch/csrc/`` of
the commit before the engine took these cells: ``git archive <commit>
deeplearning4j_tpu_torch/csrc | tar -x -C DIR``, DIR under the checkout's
git-ignored ``_chip/``), that tree's ``rnn_recurrence.cu``,
``lstm_recurrence.cu`` and ``dropout.cu`` are built with the port's nvcc
flags (each with its own directory's ``sm90.cuh``) and their C entries,
whose signatures the engine kept, are called through ctypes on the same
inputs: each output held to the plain version, then timed in turns with
this tree's, parent, this, this, parent. Every line carries the card's
name and power limit.
"""
import argparse
import ctypes
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
from deeplearning4j_tpu_torch.environment import card_info  # noqa: E402
from deeplearning4j_tpu_torch.kernels import _cuda, lstm, recurrence  # noqa: E402
from deeplearning4j_tpu_torch.kernels import dropout as dk  # noqa: E402
from deeplearning4j_tpu_torch.kernels.measure import (  # noqa: E402
    lstm_recurrence_case, median_ms, rnn_bwd_args, rnn_fwd_args,
    rnn_recurrence_case)

OUT = os.path.join(_cuda.PACKAGE, "_build", "rnn_times")
PARENT_LIBS = {"rnn_recurrence": recurrence.ARGTYPES,
               "lstm_recurrence": lstm.ARGTYPES,
               "dropout": {"dl4j_noise": dk.NOISE_ARGTYPES}}


def build_parent(d):
    """The parent tree's libraries, built together: name -> CDLL."""
    csrc = os.path.join(d, "deeplearning4j_tpu_torch", "csrc")
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for lib in PARENT_LIBS:
        so = os.path.join(OUT, f"parent_{lib}.so")
        cmd = [_cuda.nvcc(), *_cuda.NVCC_FLAGS, "-I", csrc, "-o", so,
               _cuda.source(lib, csrc)]
        procs[lib] = so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True)
    libs = {}
    for lib, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"parent {lib}: nvcc failed\n{log[-3000:]}")
        libs[lib] = ctypes.CDLL(so)
        for name, args in PARENT_LIBS[lib].items():
            _cuda.declare(getattr(libs[lib], name), args)
    return libs


def _p(t):
    return None if t is None else t.data_ptr()


def parent_rnn(lib, cell, case, resident):
    """The parent's forward and backward of ``cell`` on a case (its own
    plan: the units split as this tree's, resident as given)."""
    b, u = case["h0"].shape
    t_len = case["gx"].shape[0]
    dt = recurrence._DTYPES[case["gx"].dtype]
    ranks, _ = recurrence._sequence.split_units(u)
    st = torch.cuda.current_stream().cuda_stream
    gx = case["gx"].clone()
    hs = gx.new_empty(t_len, b, u)
    c_s = torch.empty_like(hs) if cell == "graves" else None
    hn = torch.empty_like(hs) if cell == "gru" else None

    def fwd():
        gx.copy_(case["gx"])
        err = lib.dl4j_rnn_recurrence_fwd(
            recurrence.CELLS[cell], gx.data_ptr(), case["w_hh"].data_ptr(),
            _p(case["b_hh"]), _p(case["w_peep"]), case["h0"].data_ptr(),
            _p(case["c0"]), hs.data_ptr(), _p(c_s), _p(hn), t_len, b, u,
            ranks, resident, case["act"], dt, st)
        _cuda.check(err, "parent dl4j_rnn_recurrence_fwd")
        return gx, hs, c_s, hn

    saved = case["saved"]
    dz = torch.empty_like(saved)
    dzh = torch.empty_like(saved) if cell == "gru" else dz
    dh0 = torch.empty_like(case["h0"])
    dc0 = torch.empty_like(case["h0"]) if cell == "graves" else None

    def bwd():
        err = lib.dl4j_rnn_recurrence_bwd(
            recurrence.CELLS[cell], saved.data_ptr(), case["hs"].data_ptr(),
            _p(case["cs"]), _p(case["hn"]), case["h0"].data_ptr(),
            _p(case["c0"]), case["w_hh"].data_ptr(), _p(case["w_peep"]),
            _p(case["d_hs"]), _p(case["dh_T"]), _p(case["dc_T"]),
            dz.data_ptr(), dzh.data_ptr(), dh0.data_ptr(), _p(dc0), t_len, b,
            u, ranks, resident, case["act"], dt, st)
        _cuda.check(err, "parent dl4j_rnn_recurrence_bwd")
        return dz, dzh, dh0, dc0
    return fwd, bwd


def parent_lstm(lib, gx, w, h0, c0, d_hs, dh_t, dc_t):
    t_len, b, u4 = gx.shape
    u = u4 // 4
    plan = lstm.recurrence_plan(b, u, 4)
    st = torch.cuda.current_stream().cuda_stream
    buf, hs = gx.clone(), gx.new_empty(t_len, b, u)
    c_s = torch.empty_like(hs)
    gates, _, cs_ = lstm.lstm_recurrence_fwd_plain(gx, w, h0, c0)
    dz, dh0, dc0 = torch.empty_like(gx), torch.empty_like(h0), \
        torch.empty_like(h0)

    def fwd():
        buf.copy_(gx)
        _cuda.check(lib.dl4j_lstm_recurrence_fwd(
            buf.data_ptr(), w.data_ptr(), h0.data_ptr(), c0.data_ptr(),
            hs.data_ptr(), c_s.data_ptr(), t_len, b, u, plan.ranks,
            plan.n_tiles, int(plan.resident), 0, st), "parent lstm fwd")
        return buf, hs, c_s

    def bwd():
        _cuda.check(lib.dl4j_lstm_recurrence_bwd(
            gates.data_ptr(), cs_.data_ptr(), c0.data_ptr(), w.data_ptr(),
            d_hs.data_ptr(), dh_t.data_ptr(), dc_t.data_ptr(), dz.data_ptr(),
            dh0.data_ptr(), dc0.data_ptr(), t_len, b, u, plan.ranks,
            plan.n_tiles, int(plan.resident), 0, st), "parent lstm bwd")
        return dz, dh0, dc0
    return fwd, bwd, (gates, cs_)


def worst(got, want):
    return max(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
               for g, w in zip(got, want) if w is not None)


def turns(label, fns, flush, card):
    """``fns``: {name: fn}; times each alone in the order a, b, b, a."""
    names = list(fns)
    order = names + names[::-1]
    got = {n: [] for n in names}
    for n in order:
        got[n].append(median_ms(fns[n], flush))
    print(f"{label}: " + "; ".join(
        f"{n} {[round(v, 5) for v in got[n]]} ms" for n in names)
        + f"  [{card}]", flush=True)
    return got


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="a tree holding the parent's "
                    "deeplearning4j_tpu_torch/csrc/")
    ap.add_argument("--no-gate", action="store_true",
                    help="skip phase 29's gate (i)")
    args = ap.parse_args()
    t0 = time.perf_counter()
    recurrence._lib()
    dk._lib()
    parent = build_parent(args.parent) if args.parent else None
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    card = card_info()
    print(card, flush=True)
    if not args.no_gate:
        cs.p29_check_kernels(dev)
    flush = torch.empty(2 ** 28, dtype=torch.float32, device=dev)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    for cell, (b, t, u) in (("gru", (64, 256, 256)), ("graves", (64, 256, 256)),
                            ("simple", (32, 50, 256)), ("gru", (64, 50, 512))):
        case = rnn_recurrence_case(cell, b, t, u, torch.float32, dev)
        buf = case["gx"].clone()
        fa, ba = rnn_fwd_args(case), rnn_bwd_args(case)
        plan = recurrence._card_plan(0, cell, torch.float32, b, u)
        print(f"{cell} ({b}, {t}, {u}): R {plan.ranks}, {plan.b_tile} rows a "
              f"cluster, {plan.clusters} clusters, the card holds "
              f"{plan.max_clusters}, {'resident' if plan.resident else 'streamed'}",
              flush=True)
        fwd = {"this": lambda: recurrence.recurrence_fwd(cell, buf, *fa)}
        bwd = {"this": lambda: recurrence.recurrence_bwd(cell, *ba)}
        if parent:
            pf, pb = parent_rnn(parent["rnn_recurrence"], cell, case,
                                int(u <= 256))
            e = (worst(pf(), (case["saved"], case["hs"], case["cs"],
                              case["hn"])),
                 worst(pb(), recurrence.recurrence_bwd_plain(cell, *ba)))
            print(f"  parent against plain: fwd {e[0]:.2e}, bwd {e[1]:.2e}",
                  flush=True)
            fwd = {"parent": pf, **fwd}
            bwd = {"parent": pb, **bwd}
        for d, fns in (("fwd", fwd), ("bwd", bwd)):
            got = turns(f"  {cell}_recurrence_{d} ({b}, {t}, {u}) a call",
                        fns, flush, card)
            print("    us a step: " + ", ".join(
                f"{n} {1e3 * min(v) / t:.3f}" for n, v in got.items()),
                flush=True)
    gx, w, h0, c0, d_hs, dh_t, dc_t = lstm_recurrence_case(
        32, 50, 256, torch.float32, dev)
    buf = gx.clone()
    gates, _, cs_ = lstm.lstm_recurrence_fwd_plain(gx, w, h0, c0)
    fwd = {"this": lambda: lstm.lstm_recurrence_fwd(buf, w, h0, c0)}
    bwd = {"this": lambda: lstm.lstm_recurrence_bwd(gates, cs_, c0, w, d_hs,
                                                    dh_t, dc_t)}
    if parent:
        pf, pb, _ = parent_lstm(parent["lstm_recurrence"], gx, w, h0, c0,
                                d_hs, dh_t, dc_t)
        fwd = {"parent": pf, **fwd}
        bwd = {"parent": pb, **bwd}
    for d, fns in (("fwd", fwd), ("bwd", bwd)):
        turns(f"  lstm_recurrence_{d} (32, 50, 256) a call", fns, flush, card)
    seed = torch.tensor([1], dtype=torch.int64, device=dev)
    itr = torch.tensor([2], dtype=torch.int64, device=dev)
    x = torch.randn(64, 256, 300, device=dev)
    y = torch.empty_like(x)
    fns = {"this": lambda: dk.noise_apply("gaussian_noise", x, seed, itr, 3,
                                          "gaussian_noise_fwd", stddev=0.1)}
    if parent:
        lib = parent["dropout"]

        def pn():
            _cuda.check(lib.dl4j_noise(
                0, x.data_ptr(), y.data_ptr(), x.numel(), seed.data_ptr(),
                itr.data_ptr(), 3, 0, 0.1, 0.0, 0.0, 1, 1, 1, 1,
                torch.cuda.current_stream().cuda_stream), "parent noise")
        fns = {"parent": pn, **fns}
    fns["torch.normal"] = lambda: torch.normal(x, 0.1)
    turns("  gaussian_noise_fwd (64, 256, 300) float32", fns, flush, card)
    torch.backends.cuda.matmul.allow_tf32 = tf32


if __name__ == "__main__":
    main()
