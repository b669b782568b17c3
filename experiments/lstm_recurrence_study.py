"""The LSTM recurrence's kernels on one card: the first design against the
persistent kernels, and variants of the persistent kernels that each drop
or change one part, over one TextGenLSTM layer's TBPTT chunk.

    python3 experiments/lstm_recurrence_study.py [--parent DIR] [--only a,b]

With ``--parent DIR`` (DIR holds ``deeplearning4j_tpu_torch/csrc/`` of a
commit whose ``lstm_cell.cu`` is the first design: ``git archive <commit>
deeplearning4j_tpu_torch/csrc | tar -x -C DIR``, DIR under the checkout's
git-ignored ``_chip/`` directory), that source is built with the
port's nvcc command (``_cuda.build_command``) and its two C entries are
called through ctypes in the first design's loop: a cuBLAS ``h @ W_hh``
(``addmm_``) and one cell launch a timestep forward, a cell launch and
``dz @ W_hh^T`` a timestep backward. At (B, T, U) = (32, 50, 256) and
(32, 1000, 256) (``net.output`` over a whole sequence), float32 with TF32
off, both designs run the forward and backward recurrence on the same
seeded inputs; each output is held to the plain version (1e-5 of the
largest magnitude). Each is timed as the replay of a CUDA graph that
holds it (device time, ``median_ms``: cold L2, the median of 20 replays
queued behind a device sleep; the fit tiers replay it so) and eagerly
(host clock, ``synced_ms``), in turns: first, new, new, first.

Variants of the committed ``csrc/lstm_recurrence.cu`` (a text
substitution each; one whose text the source no longer holds stops the
script before any build), built side by side into
deeplearning4j_tpu_torch/_build/study_lstm/<variant>/ (all builds started
together) and each launched with the committed plan at (32, 50, 256)
float32, forward and backward, ``median_ms`` (one launch a call):

- base: the committed source;
- nobarrier: the step's cluster barrier replaced by the block's (the
  results are wrong: what the barrier costs);
- nopush: every push to the block itself (wrong: what the distributed
  shared-memory stores cost);
- noproduct: no k step in either product (wrong: what the products
  cost);
- floor: nobarrier, nopush and noproduct together (the loop's stage
  copies, cell and writes);
- nocell: the gates' and the cell's tanh and sigmoids left out (wrong:
  what the activations cost);
- noprefetch: no stage copies after the first (wrong: what the copies
  cost);
- scalar: the stage copies and output stores an element at a time, not
  16 bytes;
- fastexp: float32's exp by ``__expf`` (the SFU's approximation);
- nostore: no step's outputs stored (wrong: what the stores cost);
- warps16: 16 warps a block (each product's K range, or units, over twice
  the warps);
- mmaonly: the float32 products' mma.sync with their operands made from
  the lane (no fragment loads or splits: what the tensor cores take);
- nomma: the products' loads and splits with each mma replaced by an
  integer fold of its operands (what feeding the tensor cores takes);
- noflush: the streamed form's mma chains run a warp's whole K, as the
  resident form's do (for ``--wide``: the error that the flush removes).

``--tiles``: the batch tile at B 64 and 128 (U 256, T 50, float32, the
resident slice): each of 1, 2 and 4 tiles of 8 rows a cluster, with the
clusters the card holds at once (its occupancy calculator) and the waves
that leaves, forward and backward ``median_ms`` in the order 1, 2, 4, 4,
2, 1; every tiling's outputs bit-equal to one tile's and held to the plain
version.

``--soak N``: the committed kernels through their wrappers, N forward and
N backward calls queued back to back (no sync between), at (B, T, U) =
(32, 50, 256), (3, 7, 37), (8, 20, 512) and (8, 20, 300) (a block's units
not a power of two groups of 8), float32 and float64; every call's
outputs bit-equal to the first's (counted on the device) and the first
held to the plain version.

``--wide``: the float32 kernels' accuracy with the width, at (B, T, U) =
(4, 3, U) for U 256, 512, 2048, 3072 and 4096 (all but 256 the streamed
form): each output of the kernels, of the float32 plain version and of
each variant named by ``--only`` against the float64 plain version on the
same inputs (the backward on the float64 forward's gates and cs, rounded
to float32), relative to the largest magnitude.

Every line carries the card's name and power limit. ``--only a,b`` runs
only those variants (``first`` names the parent comparison); with
``--tiles``, ``--soak`` or ``--wide`` and no ``--only``, no variant
runs. Each
variant's name is printed before it is timed, so a fault names it.
"""
import argparse
import ctypes
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from deeplearning4j_tpu_torch.environment import card_info  # noqa: E402
from deeplearning4j_tpu_torch.kernels import _cuda, lstm  # noqa: E402
from deeplearning4j_tpu_torch.kernels import measure  # noqa: E402

OUT = os.path.join(_cuda.PACKAGE, "_build", "study_lstm")
_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
#: the first design's C entries (its kernels/lstm.py ARGTYPES)
FIRST_ARGTYPES = {
    "dl4j_lstm_cell_fwd": ([(n, _P) for n in ("z", "c_prev", "h", "c")]
                           + [("B", _I64), ("U", _I64), ("dtype", _I),
                              ("stream", _P)]),
    "dl4j_lstm_cell_bwd": ([(n, _P) for n in (
        "gates", "c_prev", "c", "dh_up", "dh_next", "dc_next", "dz",
        "dc_prev")] + [("B", _I64), ("U", _I64), ("dtype", _I),
                       ("stream", _P)]),
}
SHAPES = ((32, 50, 256), (32, 1000, 256))
# the block's barrier in place of the cluster's after the first step, and
# the cluster's once more before the exit (no block exits while another
# still pushes into it)
NOBARRIER = [
    ("    cluster_wait();   // h_{t-1} from every block (the tiles, at t = 0)\n",
     "    if (t == 0) cluster_wait(); else __syncthreads();\n", 1),
    ("    cluster_arrive();   // h_t pushed\n", "", 1),
    ("  cluster_wait();   // no block exits while another still pushes into "
     "it\n", "  cluster_arrive();\n  cluster_wait();\n", 1),
    ("    cluster_wait();   // step t + 1's partials from every block\n",
     "    if (t == a.steps - 1) cluster_wait(); else __syncthreads();\n", 1),
    ("    cluster_arrive();   // the partials pushed\n", "", 1),
    ("  cluster_wait();   // step 0's partials; no block exits while another "
     "pushes\n", "  cluster_arrive();\n  cluster_wait();\n", 1)]
NOPUSH = [("const uint32_t to = peer(dst(r % ROWS) + c, r / ROWS);",
           "const uint32_t to = peer(dst(r % ROWS) + c, cluster_rank());", 1),
          ("g.ldg + ju, owner), acc[n][hh * 2 + e]);",
           "g.ldg + ju, rank), acc[n][hh * 2 + e]);", 1)]
NOPRODUCT = [("for (int kk = kb; kk < kend; kk += 2) {   // k1 - k0 is even",
              "for (int kk = kb; kk < kb; kk += 2) {", 2)]
VARIANTS = {
    "base": [],
    "nobarrier": NOBARRIER,
    "nopush": NOPUSH,
    "noproduct": NOPRODUCT,
    "floor": NOBARRIER + NOPUSH + NOPRODUCT,
    "nocell": [("const T i = sigmoid_(z[0]), f = sigmoid_(z[1]), gg = "
                "tanh_(z[2]), o = sigmoid_(z[3]);",
                "const T i = z[0], f = z[1], gg = z[2], o = z[3];", 2),
               ("const T hn = o * tanh_(cn);", "const T hn = o * cn;", 1),
               ("const T tc = tanh_(ct);", "const T tc = ct;", 2)],
    "noprefetch": [("if (t + 1 < a.steps) stage(t + 1, s ^ 1);", "", 1),
                   ("if (t > 0) stage(t - 1, s ^ 1);", "", 1)],
    "scalar": [("a.vec = vec_ok<T>(U, R, {z, w_hh, hs, cs});", "a.vec = 0;",
                1),
               ("a.vec = vec_ok<T>(U, R, {gates, cs, c0, w_hh, d_hs, dz});",
                "a.vec = 0;", 1)],
    "fastexp": [("float exp_(float x) { return expf(x); }",
                 "float exp_(float x) { return __expf(x); }", 1)],
    "warps16": [("constexpr int kWarps = 8;", "constexpr int kWarps = 16;", 1)],
    "noflush": [("constexpr int kFlush = 16;", "constexpr int kFlush = 0;", 1)],
    "nostore": [("    store_rows<T>(\n", "    if (t < 0) store_rows<T>(\n", 2)],
    # the float32 products' mma with no loads or splits behind them (their
    # operands made from the lane), and their loads and splits with no mma
    # (each mma replaced by an integer fold of its operands into c[0])
    "mmaonly": [
        ("for (int h = 0; h < 2; ++h) tf32_split4(w.frag((G * kt + kk) * 2 + "
         "h, lane), ah[h], al[h]);",
         "for (int h = 0; h < 2; ++h) for (int i = 0; i < 4; ++i) ah[h][i] = "
         "al[h][i] = lane + kk;", 1),
        ("    tf32_split(hp(n * 8 + gi, u0), bh[0], bl[0]);\n    tf32_split(hp("
         "n * 8 + gi, u1), bh[1], bl[1]);\n",
         "    bh[0] = bh[1] = bl[0] = bl[1] = lane + n;\n", 1),
        ("tf32_split4(w.frag(mt * nk + kk, lane), ah, al);",
         "for (int i = 0; i < 4; ++i) ah[i] = al[i] = lane + kk;", 1),
        ("    tf32_split(dz(n * 8 + gi, k), bh[0], bl[0]);\n    tf32_split(dz(n * "
         "8 + gi, k + 4), bh[1], bl[1]);\n",
         "    bh[0] = bh[1] = bl[0] = bl[1] = lane + n;\n", 1)],
    "nomma": [
        ("__device__ __forceinline__ void tf32_split4(",
         "__device__ __forceinline__ void fold(float c[4], const uint32_t a[4], "
         "const uint32_t b[2]) {\n  c[0] += __uint_as_float((a[0] ^ a[1] ^ a[2] "
         "^ a[3] ^ b[0] ^ b[1]) & 0x3f800000u);\n}\n\n"
         "__device__ __forceinline__ void tf32_split4(", 1),
        ("      mma_tf32(sm[h][n], al[h], bh);\n      mma_tf32(sm[h][n], ah[h], "
         "bl);\n      mma_tf32(bg[h][n], ah[h], bh);",
         "      fold(sm[h][n], al[h], bh);\n      fold(sm[h][n], ah[h], bl);\n"
         "      fold(bg[h][n], ah[h], bh);", 1),
        ("    mma_tf32(sm[n], al, bh);\n    mma_tf32(sm[n], ah, bl);\n    "
         "mma_tf32(bg[n], ah, bh);",
         "    fold(sm[n], al, bh);\n    fold(sm[n], ah, bl);\n    "
         "fold(bg[n], ah, bh);", 1)],
}


def variant_source(subs):
    with open(_cuda.source(lstm._LIB)) as f:
        src = f.read()
    for a, b, n in subs:
        if src.count(a) != n:
            raise SystemExit(f"the source no longer holds {a!r} {n} times")
        src = src.replace(a, b)
    return src


def build(name, src_dir, lib_name, out):
    t0 = time.perf_counter()
    res = subprocess.run(
        _cuda.build_command(lib_name, out, _cuda.nvcc(), csrc=src_dir),
        capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise SystemExit(f"{name} did not build:\n{res.stderr}")
    return name, time.perf_counter() - t0


def build_all(names, parent):
    """Every variant's library (and the first design's), built together:
    {name: ctypes library}."""
    jobs = {}
    for name in names:
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"{lstm._LIB}.cu"), "w") as f:
            f.write(variant_source(VARIANTS[name]))
        jobs[name] = (d, lstm._LIB, os.path.join(d, f"lib{lstm._LIB}.so"),
                      lstm.ARGTYPES)
    if parent:
        d = os.path.join(OUT, "first")
        os.makedirs(d, exist_ok=True)
        jobs["first"] = (os.path.join(parent, "deeplearning4j_tpu_torch",
                                      "csrc"), "lstm_cell",
                         os.path.join(d, "liblstm_cell.so"), FIRST_ARGTYPES)
    if not jobs:
        return {}
    with ThreadPoolExecutor(len(jobs)) as ex:
        for name, secs in ex.map(lambda kv: build(kv[0], *kv[1][:3]),
                                 jobs.items()):
            print(f"{name} built in {secs:.1f} s", flush=True)
    libs = {}
    for name, (_, _, path, argtypes) in jobs.items():
        lib = libs[name] = ctypes.CDLL(path)
        for entry, args in argtypes.items():
            _cuda.declare(getattr(lib, entry), args)
    return libs


def _stream():
    return torch.cuda.current_stream().cuda_stream


def close(got, want, what):
    err = float((got.double() - want.double()).abs().max())
    tol = 1e-5 * max(float(want.abs().max()), 1e-30)
    if err > tol:
        raise SystemExit(f"{what}: error {err:.3e} over {tol:.3e}")
    return err


def graph_of(fn):
    """``fn`` captured in a CUDA graph (warmed up on a side stream)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return g


def first_vs_new(first_lib, b, t, u, card, flush):
    """Both designs' recurrence at (b, t, u), held to the plain version,
    timed as graph replays and eagerly, in turns."""
    gx, w, h0, c0, d_hs, dh_t, dc_t = measure.lstm_recurrence_case(
        b, t, u, torch.float32, torch.device("cuda"))
    want_f = lstm.lstm_recurrence_fwd_plain(gx, w, h0, c0)
    gates, cs = want_f[0], want_f[2]
    want_b = lstm.lstm_recurrence_bwd_plain(gates, cs, c0, w, d_hs, dh_t,
                                            dc_t)
    # the first design's buffers: its gates over gx, dh and dc carried
    f_gx, f_hs, f_cs = gx.clone(), torch.empty_like(want_f[1]), \
        torch.empty_like(cs)
    f_dz, f_dh, f_dc = torch.empty_like(gates), dh_t.clone(), dc_t.clone()
    w_t = w.t()
    n_buf = gx.clone()

    def first_fwd():
        h, c = h0, c0
        for s in range(t):
            f_gx[s].addmm_(h, w)
            _cuda.check(first_lib.dl4j_lstm_cell_fwd(
                f_gx[s].data_ptr(), c.data_ptr(), f_hs[s].data_ptr(),
                f_cs[s].data_ptr(), b, u, 0, _stream()), "first fwd")
            h, c = f_hs[s], f_cs[s]

    def first_bwd():
        for s in range(t - 1, -1, -1):
            _cuda.check(first_lib.dl4j_lstm_cell_bwd(
                gates[s].data_ptr(), (cs[s - 1] if s else c0).data_ptr(),
                cs[s].data_ptr(), d_hs[s].data_ptr(), f_dh.data_ptr(),
                f_dc.data_ptr(), f_dz[s].data_ptr(), f_dc.data_ptr(), b, u,
                0, _stream()), "first bwd")
            torch.mm(f_dz[s], w_t, out=f_dh)

    def new_fwd():
        return lstm.lstm_recurrence_fwd(n_buf, w, h0, c0)

    def new_bwd():
        return lstm.lstm_recurrence_bwd(gates, cs, c0, w, d_hs, dh_t, dc_t)

    first_fwd()
    first_bwd()
    n_buf.copy_(gx)
    got = new_fwd() + new_bwd()
    torch.cuda.synchronize()
    errs = {"first": max(close(a, w_, "the first design") for a, w_ in zip(
        (f_gx, f_hs, f_cs, f_dz, f_dh, f_dc), want_f + want_b)),
        "new": max(close(a, w_, "the new design")
                   for a, w_ in zip(got, want_f + want_b))}
    fns = {"first": (first_fwd, first_bwd), "new": (new_fwd, new_bwd)}
    res = {}
    for design in ("first", "new", "new", "first"):
        for d, fn in zip(("fwd", "bwd"), fns[design]):
            row = res.setdefault((design, d), {"graph": [], "eager": []})
            g = graph_of(fn)
            row["graph"].append(measure.median_ms(g.replay, flush))
            del g
            row["eager"].append(measure.synced_ms(fn, flush))
    for (design, d), row in res.items():
        launches = 1 if design == "new" else 2 * t
        print(f"  {design:5s} {d} (B {b}, T {t}, U {u}) float32: in a CUDA "
              f"graph {' / '.join(f'{v:.5f}' for v in row['graph'])} ms "
              f"({1e3 * min(row['graph']) / t:.3f} us a step), eager "
              f"{' / '.join(f'{v:.4f}' for v in row['eager'])} ms (host "
              f"clock); {launches} launches a call; error to plain "
              f"{errs[design]:.2e}  [{card}]", flush=True)


def time_variants(libs, names, card, flush, b=32, t=50, u=256):
    """Each variant's forward and backward at (b, t, u) float32 with the
    committed plan: device ms a call and us a step, in the order given
    and back."""
    dev = torch.device("cuda")
    gx, w, h0, c0, d_hs, dh_t, dc_t = measure.lstm_recurrence_case(
        b, t, u, torch.float32, dev)
    gates, hs, cs = lstm.lstm_recurrence_fwd_plain(gx, w, h0, c0)
    plan = lstm._card_plan(0, torch.float32, b, u)
    split = (plan.ranks, plan.n_tiles, int(plan.resident), 0)
    buf, hs2, cs2 = gx.clone(), torch.empty_like(hs), torch.empty_like(cs)
    dz, dh0, dc0 = torch.empty_like(gates), torch.empty_like(c0), \
        torch.empty_like(c0)

    def fwd(lib):
        _cuda.check(lib.dl4j_lstm_recurrence_fwd(
            buf.data_ptr(), w.data_ptr(), h0.data_ptr(), c0.data_ptr(),
            hs2.data_ptr(), cs2.data_ptr(), t, b, u, *split, _stream()),
            "fwd")

    def bwd(lib):
        _cuda.check(lib.dl4j_lstm_recurrence_bwd(
            gates.data_ptr(), cs.data_ptr(), c0.data_ptr(), w.data_ptr(),
            d_hs.data_ptr(), dh_t.data_ptr(), dc_t.data_ptr(), dz.data_ptr(),
            dh0.data_ptr(), dc0.data_ptr(), t, b, u, *split, _stream()),
            "bwd")

    res = {}
    for name in names + names[::-1]:
        print(f"  timing {name}", flush=True)
        for d, fn in (("fwd", fwd), ("bwd", bwd)):
            res.setdefault((name, d), []).append(
                measure.median_ms(lambda: fn(libs[name]), flush))
    for name in names:
        print(f"  {name:10s} (B {b}, T {t}, U {u}) float32, R {plan.ranks}, "
              f"{plan.b_tile} rows a cluster, {plan.clusters} clusters: "
              + "; ".join(
                  f"{d} {' / '.join(f'{v:.5f}' for v in res[(name, d)])} ms "
                  f"({1e3 * min(res[(name, d)]) / t:.3f} us a step)"
                  for d in ("fwd", "bwd")) + f"  [{card}]", flush=True)


def tiles_vs_waves(card, flush, t=50, u=256):
    """1, 2 and 4 tiles of 8 rows a cluster at B 64 and 128 (the resident
    slice): clusters, the card's clusters at once, waves, device ms."""
    dev, dt = torch.device("cuda"), torch.float32
    lib = lstm._lib()
    for b in (64, 128):
        gx, w, h0, c0, d_hs, dh_t, dc_t = measure.lstm_recurrence_case(
            b, t, u, dt, dev)
        want_f = lstm.lstm_recurrence_fwd_plain(gx, w, h0, c0)
        gates, cs = want_f[0], want_f[2]
        want_b = lstm.lstm_recurrence_bwd_plain(gates, cs, c0, w, d_hs, dh_t,
                                                dc_t)
        plan = lstm._card_plan(0, dt, b, u)
        buf = gx.clone()
        hs2, cs2 = torch.empty_like(cs), torch.empty_like(cs)
        dz, dh0, dc0 = torch.empty_like(gates), torch.empty_like(c0), \
            torch.empty_like(c0)

        def run(nt, d):
            split = (plan.ranks, nt, int(plan.resident), 0)
            if d == "fwd":
                buf.copy_(gx)
                _cuda.check(lib.dl4j_lstm_recurrence_fwd(
                    buf.data_ptr(), w.data_ptr(), h0.data_ptr(),
                    c0.data_ptr(), hs2.data_ptr(), cs2.data_ptr(), t, b, u,
                    *split, _stream()), "fwd")
            else:
                _cuda.check(lib.dl4j_lstm_recurrence_bwd(
                    gates.data_ptr(), cs.data_ptr(), c0.data_ptr(),
                    w.data_ptr(), d_hs.data_ptr(), dh_t.data_ptr(),
                    dc_t.data_ptr(), dz.data_ptr(), dh0.data_ptr(),
                    dc0.data_ptr(), t, b, u, *split, _stream()), "bwd")

        outs = {}
        for nt in lstm.N_TILES:
            run(nt, "fwd")
            run(nt, "bwd")
            torch.cuda.synchronize()
            outs[nt] = [x.clone() for x in (buf, hs2, cs2, dz, dh0, dc0)]
            for got, want in zip(outs[nt], want_f + want_b):
                close(got, want, f"{nt} tiles")
            if not all(torch.equal(x, y) for x, y in zip(outs[nt], outs[1])):
                raise SystemExit(f"B {b}: {nt} tiles not bit-equal to 1")
        res = {}
        for nt in lstm.N_TILES + lstm.N_TILES[::-1]:
            for d in ("fwd", "bwd"):
                res.setdefault((nt, d), []).append(measure.median_ms(
                    lambda: run(nt, d), flush))
        for nt in lstm.N_TILES:
            q = lstm.query(u, plan.ranks, nt, plan.resident, dt)
            clusters = -(-b // (8 * nt))
            held = min(q[2], q[3])
            print(f"  tiles {nt} (B {b}, T {t}, U {u}) float32, R "
                  f"{plan.ranks}: {8 * nt} rows a cluster, {clusters} "
                  f"clusters, the card holds {q[2]} / {q[3]} at once "
                  f"(fwd / bwd), {-(-clusters // max(1, held))} waves"
                  f"{' (the plan)' if nt == plan.n_tiles else ''}: "
                  + "; ".join(
                      f"{d} {' / '.join(f'{v:.5f}' for v in res[(nt, d)])} "
                      f"ms" for d in ("fwd", "bwd"))
                  + f"; bit-equal to 1 tile  [{card}]", flush=True)


def lib_fwd(lib, plan, gx, w, h0, c0):
    """A variant library's forward through its C entry with ``plan``'s
    split: (gates, hs, cs)."""
    t, b, u = gx.shape[0], gx.shape[1], gx.shape[2] // 4
    split = (plan.ranks, plan.n_tiles, int(plan.resident),
             0 if gx.dtype == torch.float32 else 1)
    z, hs, cs = gx.clone(), gx.new_empty(t, b, u), gx.new_empty(t, b, u)
    _cuda.check(lib.dl4j_lstm_recurrence_fwd(
        z.data_ptr(), w.data_ptr(), h0.data_ptr(), c0.data_ptr(),
        hs.data_ptr(), cs.data_ptr(), t, b, u, *split, _stream()), "fwd")
    return z, hs, cs


def lib_bwd(lib, plan, gates, cs, c0, w, d_hs, dh_t, dc_t):
    """The same library's backward: (dz, dh0, dc0)."""
    t, b, u = cs.shape
    split = (plan.ranks, plan.n_tiles, int(plan.resident),
             0 if cs.dtype == torch.float32 else 1)
    dz, dh0, dc0 = torch.empty_like(gates), torch.empty_like(c0), \
        torch.empty_like(c0)
    _cuda.check(lib.dl4j_lstm_recurrence_bwd(
        gates.data_ptr(), cs.data_ptr(), c0.data_ptr(), w.data_ptr(),
        d_hs.data_ptr(), dh_t.data_ptr(), dc_t.data_ptr(), dz.data_ptr(),
        dh0.data_ptr(), dc0.data_ptr(), t, b, u, *split, _stream()), "bwd")
    return dz, dh0, dc0


def wide(card, libs):
    """The float32 kernels, the float32 plain version and the variants in
    ``libs`` against the float64 plain version, by width."""
    dev = torch.device("cuda")
    names = ("gates", "hs", "cs", "dz", "dh0", "dc0")

    def rel(a, b):
        return float((a.double() - b).abs().max() / b.abs().max())

    for u in (256, 512, 2048, 3072, 4096):
        b, t = 4, 3
        case = measure.lstm_recurrence_case(b, t, u, torch.float32, dev,
                                            seed=u)
        gx, w, h0, c0, d_hs, dh_t, dc_t = case
        d = [x.double() for x in case]
        exact = lstm.lstm_recurrence_fwd_plain(*d[:4])
        # the backward's inputs: the exact forward's, in float32
        gates, cs = exact[0].float(), exact[2].float()
        bwd_in = (gates, cs, c0, w, d_hs, dh_t, dc_t)
        exact += lstm.lstm_recurrence_bwd_plain(
            gates.double(), cs.double(), d[3], d[1], *d[4:])
        got = {"kernel": lstm.lstm_recurrence_fwd(gx.clone(), w, h0, c0)
               + lstm.lstm_recurrence_bwd(*bwd_in),
               "plain": lstm.lstm_recurrence_fwd_plain(gx, w, h0, c0)
               + lstm.lstm_recurrence_bwd_plain(*bwd_in)}
        plan = lstm._card_plan(0, torch.float32, b, u)
        for name, lib in libs.items():
            got[name] = lib_fwd(lib, plan, gx, w, h0, c0) + \
                lib_bwd(lib, plan, *bwd_in)
        for who, outs in got.items():
            print(f"  wide (B {b}, T {t}, U {u}) float32, "
                  f"{'resident' if plan.resident else 'streamed'}, {who} "
                  f"against float64: " + ", ".join(
                      f"{n} {rel(x, y):.3e}" for n, x, y in zip(
                          names, outs, exact)) + f"  [{card}]", flush=True)


def soak(n, card):
    """n forward and n backward wrapper calls queued back to back at each
    shape and type; every call's outputs bit-equal to the first's."""
    dev = torch.device("cuda")
    for dt in (torch.float32, torch.float64):
        for b, t, u in ((32, 50, 256), (3, 7, 37), (8, 20, 512),
                        (8, 20, 300)):
            gx, w, h0, c0, d_hs, dh_t, dc_t = measure.lstm_recurrence_case(
                b, t, u, dt, dev, seed=u)
            buf = gx.clone()
            first = list(lstm.lstm_recurrence_fwd(buf, w, h0, c0))
            first += lstm.lstm_recurrence_bwd(first[0], first[2], c0, w, d_hs,
                                              dh_t, dc_t)
            first[0] = first[0].clone()
            want_f = lstm.lstm_recurrence_fwd_plain(gx, w, h0, c0)
            want_b = lstm.lstm_recurrence_bwd_plain(
                want_f[0], want_f[2], c0, w, d_hs, dh_t, dc_t)
            tol = 1e-5 if dt == torch.float32 else 1e-12
            for got, want in zip(first, want_f + want_b):
                err = float((got - want).abs().max())
                if err > tol * max(float(want.abs().max()), 1e-30):
                    raise SystemExit(f"soak {b, t, u} {dt}: error {err:.3e}")
            bad = torch.zeros((), dtype=torch.int64, device=dev)
            t0 = time.perf_counter()
            for _ in range(n):
                buf.copy_(gx)
                f = lstm.lstm_recurrence_fwd(buf, w, h0, c0)
                g = lstm.lstm_recurrence_bwd(f[0], f[2], c0, w, d_hs, dh_t,
                                             dc_t)
                for x, y in zip(f + g, first):
                    bad += (x != y).sum()
            torch.cuda.synchronize()
            print(f"  soak (B {b}, T {t}, U {u}) {dt}: {n} forward and {n} "
                  f"backward calls in {time.perf_counter() - t0:.1f} s, "
                  f"{int(bad)} values unlike the first call's  [{card}]",
                  flush=True)
            if int(bad):
                raise SystemExit("the soak's calls differ")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a directory holding "
                    "deeplearning4j_tpu_torch/csrc/ with the first design's "
                    "lstm_cell.cu")
    ap.add_argument("--only", help="comma-separated variants (first: the "
                    "parent comparison)")
    ap.add_argument("--tiles", action="store_true",
                    help="1, 2 and 4 tiles of 8 rows a cluster at B 64, 128")
    ap.add_argument("--soak", type=int, default=0, metavar="N",
                    help="N queued calls of the committed kernels a shape")
    ap.add_argument("--wide", action="store_true",
                    help="the float32 kernels' error by width")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    only = opts.only.split(",") if opts.only else None
    if only is None and (opts.tiles or opts.soak or opts.wide):
        only = []
    names = [n for n in VARIANTS if only is None or n in only]
    parent = opts.parent if only is None or "first" in only else None
    card = card_info()
    print(f"card: {card}", flush=True)
    libs = build_all(names, parent)
    lstm._lib()
    flush = torch.empty(2 ** 28, dtype=torch.float32, device="cuda")
    if parent:
        for b, t, u in SHAPES:
            first_vs_new(libs["first"], b, t, u, card, flush)
    if names:
        time_variants(libs, names, card, flush)
    if opts.tiles:
        tiles_vs_waves(card, flush)
    if opts.soak:
        soak(opts.soak, card)
    if opts.wide:
        wide(card, {n: libs[n] for n in names})
    return 0


if __name__ == "__main__":
    sys.exit(main())
