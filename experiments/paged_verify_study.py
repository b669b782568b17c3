"""Variants of csrc/paged_attention.cu's verify kernel built side by side
and timed on one card: what each part of its time is, and what each knob
gives.

    python3 experiments/paged_verify_study.py [--parent DIR]

Each variant is the committed source with one change (a text substitution
below; a substitution whose text the source no longer holds stops the
script before any build), built by the port's nvcc command
(``_cuda.build_command``), all builds started together, into
deeplearning4j_tpu_torch/_build/study_verify/<variant>/; a variant that
does not build stops the script with a non-zero exit. Each is launched
through ``paged_attention._launch`` at a GPT-medium verify: 8 lanes x W
8 rows x 12 heads of 128, float32, blocks of 16, every lane's window from
context 64, 128, 512 and 1016, and at two launches of chip_smoke.py's
speculative traffic (``chip_smoke.verify_mixes``: its first round's lanes
and a round of its long tail). Times are ``kernels/measure.py``'s
``median_ms`` (cold L2, the median of 20 calls queued behind a device
sleep); each variant's rows are held to the decode kernel's bits over the
same rows and keys (variants that drop work are wrong on purpose). The
library's masked ``F.scaled_dot_product_attention`` and the bound (bytes
over 3.35 TB/s) are printed beside. Each variant is timed in a process
of its own (``--variant NAME``), which loads only its library; its
ptxas registers and spills at <float, 128> are printed after the builds.
Variants:

- v1 (with ``--parent DIR``, a checkout of the commit before this design,
  whose ``csrc/paged_attention.cu`` verify entry is the first design under
  the same name and arguments): each row a decode cluster;
- base: the committed source (2 blocks a cluster of 8 rows, 2 warpgroups
  of 4 rows a block, 4 chunk slots, 2 blocks an SM);
- cluster1, cluster2, cluster4, cluster8: that many blocks a cluster, each
  taking the decode's ranks rank, rank + blocks, ... in turn;
- rows4, rows4c8: 4 rows a cluster (half a lane's window at W = 8; with
  8 blocks a cluster, one a rank);
- minblocks3: registers for 3 blocks an SM (and 2 chunk slots);
- qsmem: the rows' q in shared memory, not registers;
- parts1, parts4: 1 warpgroup of 8 rows, 4 of 2;
- ring1, ring2: that many chunk slots a block;
- nomath: no scores, softmax or V sums (copies, waits and the combine);
- noepi: no combine, no pushes and no output (copies and the math);
- empty: the kernel returns at once (a cluster launch of this grid: the
  floor).

With ``--cache int8`` the same cases run over an int8 copy of the cache
(``measure.int8_cache``: per-(head, channel) absmax scales), through the
int8 kernel (``paged_verify_i8_kernel``), and the variants are that
kernel's:

- v1 (with ``--parent DIR``, the commit before its design): the first
  int8 form (``paged_verify_kernel<float, int8_t, D>``: each key's score
  a shuffle butterfly in every row's lanes, I2F conversions in both
  warpgroups, the window filled element by element);
- base: the committed source;
- butterfly: phase 2 as the decode computes it (a lane partial a thread,
  the shuffle butterfly; q from shared memory) instead of the tree in
  registers;
- i2f: phase 1's conversion by I2F (a cast) instead of byte permutes;
- fillnow: the window's chunk copied whole and its window rows quantised
  into the ring element by element behind a barrier, as the first form;
- cluster1, cluster4, cluster8: that many blocks a cluster;
- ring2, ring4: that many chunk slots a block (one in the source);
- minblocks1: registers for one block an SM (no spills);
- convonly: phase 1 alone (no scores, softmax or V sums);
- noscores, nophase3: without phase 2 (the scores) or 3 (the softmax
  and the V sums): what each costs;
- nomath: no phase at all (the copies, waits and combine);
- empty: the kernel returns at once (the floor).

``--only a,b`` times only those variants.
"""
import argparse
import ctypes
import os
import re
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from deeplearning4j_tpu_torch.kernels import _cuda  # noqa: E402
from deeplearning4j_tpu_torch.kernels import measure  # noqa: E402
from deeplearning4j_tpu_torch.kernels import paged_attention as pa  # noqa
import chip_smoke  # noqa: E402

OUT = os.path.join(_cuda.PACKAGE, "_build", "study_verify")
SRC = open(_cuda.source(pa._LIB)).read()
CONTEXTS = (64, 128, 512, 1016)
LANES, W = 8, 8


def sub(s, a, b, count=1):
    assert s.count(a) == count, a
    return s.replace(a, b)


def cut(s, start, end, repl=""):
    """``s`` with the text from ``start`` up to (not including) ``end``
    replaced by ``repl``; each marker must occur once."""
    assert s.count(start) == 1 and s.count(end) == 1, (start, end)
    i, j = s.index(start), s.index(end)
    assert i < j, (start, end)
    return s[:i] + repl + s[j:]


_KNOBS = {name: re.search(rf"constexpr int {name} = (\d+);", SRC).group(0)
          for name in ("kVParts", "kVRing", "kVCluster", "kVMinBlocks",
                       "kVRows")}


def knob(name, value, src=SRC):
    return sub(src, _KNOBS[name], f"constexpr int {name} = {value};")


def qsmem(src):
    """The rows' q kept in shared memory, read at each key."""
    src = sub(src, "  T qr[RP][SL][E], acc[RP][SL][E], m[RP], l[RP];\n",
              "  T acc[RP][SL][E], m[RP], l[RP];\n"
              "  __shared__ __align__(16) T s_q[R][D];\n")
    src = sub(src, "        qr[i][j][e] = row < a.N ? qp[d] : T(0);\n",
              "        if (sid == 0) s_q[part * RP + i][d] = row < a.N ? qp[d] : "
              "T(0);\n")
    return sub(src, "#pragma unroll\n              for (int e = 0; e < E; "
               "++e) dot[x] += qr[x][j][e] * kr[j][e];\n",
               "              {\n                T qr[E];\n"
               "                ldkv<false, T, E>(&s_q[part * RP + x][(gl + G * j) "
               "* E], nullptr, qr);\n#pragma unroll\n"
               "                for (int e = 0; e < E; ++e) dot[x] += qr[e] "
               "* kr[j][e];\n              }\n")


VARIANTS = {
    "base": SRC,
    **{f"cluster{n}": knob("kVCluster", n) for n in (1, 2, 4, 8)},
    "minblocks3": knob("kVRing", 2, knob("kVMinBlocks", 3)),
    "qsmem": qsmem(SRC),
    "rows4": knob("kVRows", 4),
    "rows4c8": knob("kVRows", 4, knob("kVCluster", 8)),
    **{f"parts{n}": knob("kVParts", n) for n in (1, 4)},
    **{f"ring{n}": knob("kVRing", n) for n in (1, 2)},
    "nomath": cut(SRC,
                  "        // this thread's rows that take this chunk",
                  "        if (k + nring < mine) {"),
    "noepi": sub(sub(SRC, "    // rank rk's partial: each row's streams'",
                     "    if (m[0] == T(1234.5)) static_cast<T*>(a.out)[0] = "
                     "l[0];\n    if (a.A > 0) continue;\n"
                     "    // rank rk's partial: each row's streams'"),
                 "  // this block's rows: r = rank, rank + kVCluster",
                 "  asm volatile(\"barrier.cluster.wait.aligned;\\n\" ::: "
                 "\"memory\");\n  if (a.A > 0) return;\n"
                 "  // this block's rows: r = rank, rank + kVCluster"),
    "empty": sub(SRC, "  const int grp = static_cast<int>(cid / a.A);\n",
                 "  if (a.A > 0) return;\n"
                 "  const int grp = static_cast<int>(cid / a.A);\n"),
}


_I8_KNOBS = {name: re.search(rf"constexpr int {name} = (\d+);", SRC).group(0)
             for name in ("kQCluster", "kQRing", "kQMinBlocks")}


def i8knob(name, value, src=SRC):
    return sub(src, _I8_KNOBS[name], f"constexpr int {name} = {value};")


def i8_butterfly(src):
    """Phase 2 as the decode computes it: a thread's lane partial of its
    stream's keys for its 4 rows, then the shuffle butterfly, q read from
    shared memory."""
    src = sub(src, "  int ent = 0;\n  if (a.bulk && tall < 32 && r0 < a.N && (rank + "
              "kRanks * ln) * kChunk < reach)\n    ent = a.tables[static_cast<int64_t>"
              "(a.lane[r0]) * a.MAXB +\n                   (rank + kRanks * ln) * "
              "kChunk / a.BS];\n  if (tall < R) {",
              "  __shared__ __align__(16) float s_qv[R][D];\n"
              "  for (int p = tall; p < R * D; p += NT) {\n"
              "    const int row = r0 + p / D;\n"
              "    s_qv[p / D][p % D] = row < a.N ? fold<true>(static_cast<const float*>"
              "(a.q)[static_cast<int64_t>(row) * a.sqn + sqh + p % D], a.ksc + "
              "static_cast<int64_t>(head) * D + p % D) : 0.0f;\n  }\n"
              "  int ent = 0;\n  if (a.bulk && tall < 32 && r0 < a.N && (rank + "
              "kRanks * ln) * kChunk < reach)\n    ent = a.tables[static_cast<int64_t>"
              "(a.lane[r0]) * a.MAXB +\n                   (rank + kRanks * ln) * "
              "kChunk / a.BS];\n  if (tall < R) {")
    return cut(src, "        // 2. the scores", "        // 3. each row's running max",
               "        if (live) {\n"
               "#pragma unroll\n"
               "          for (int jj = 0; jj < KPS; ++jj) {\n"
               "            const int i = sid + S * jj;\n"
               "            const float4 kk = *reinterpret_cast<const float4*>(fk + i * KP + "
               "4 * gl);\n"
               "#pragma unroll\n"
               "            for (int x = 0; x < RP; ++x) {\n"
               "              const float* qq = &s_qv[part * RP + x][4 * gl];\n"
               "              float s = __fmaf_rn(qq[0], kk.x, 0.0f);\n"
               "              s = __fmaf_rn(qq[1], kk.y, s);\n"
               "              s = __fmaf_rn(qq[2], kk.z, s);\n"
               "              s = __fmaf_rn(qq[3], kk.w, s);\n"
               "#pragma unroll\n"
               "              for (int off = G / 2; off > 0; off >>= 1)\n"
               "                s = __fadd_rn(s, __shfl_xor_sync(kFull, s, off));\n"
               "              if (gl == 0) s_score[part * RP + x][sid][jj] = __fmul_rn(s, scale);\n"
               "            }\n          }\n        }\n        __syncthreads();\n")


def i8_fillnow(src):
    """The first form's window fill: a chunk reaching the window copied
    whole (none if its first key is a window key), its window rows
    quantised into the ring element by element, then a barrier; phase 1
    reads every row from the ring."""
    src = sub(src, "    const int below = w0 < 0 ? kChunk : min(kChunk, max(0, w0 - c * "
              "kChunk));", "    const int below = w0 >= 0 && w0 <= c * kChunk ? 0 : kChunk;")
    src = sub(src, "        // 1. the chunk as float32",
              "        if (w0 >= 0 && t0 + kChunk - 1 >= w0) {\n"
              "          int8_t* sw = ring + static_cast<int64_t>(slot) * L::kSlotElems;\n"
              "          for (int p = tall; p < 2 * kChunk * D; p += NT) {\n"
              "            const int kv = p / (kChunk * D), i = (p / D) % kChunk, d = p % D;\n"
              "            const int t = t0 + i, nr = wrk0 + t;\n"
              "            if (t >= w0 && t <= ulast && nr >= 0 && nr < a.N)\n"
              "              sw[kv * kChunk * D + i * D + d] = stored<int8_t>(static_cast<"
              "const float*>(kv ? a.v_new : a.k_new)[static_cast<int64_t>(nr) * a.sqn + "
              "sqh + d], &s_sc[kv][d]);\n"
              "          }\n          __syncthreads();\n        }\n"
              "        // 1. the chunk as float32")
    return sub(src, "        if (w0 >= 0 && t0 + kChunk - 1 >= w0) {\n          for (int p = "
               "tall; p < 2 * kChunk * W; p += NT) {",
               "        if (false) {\n          for (int p = tall; p < 2 * kChunk * W; "
               "p += NT) {")


def i8_variants():
    """The int8 kernel's variants (``--cache int8``)."""
    phase1 = ("        // 1. the chunk as float32",
              "        // the slot is read: order that")
    math = ("        // 2. the scores",
            "      item += mine;\n    }\n    // the chunks' buffers are read")
    return {
        "base": SRC,
        "butterfly": i8_butterfly(SRC),
        "i2f": cut(SRC, "  const uint32_t x = w ^ 0x80808080u;",
                   "}\n\n// 4 values of a new row (src) in stored form",
                   "  const char4 c = *reinterpret_cast<const char4*>(&w);\n"
                   "  return make_float4(static_cast<float>(c.x), static_cast<"
                   "float>(c.y), static_cast<float>(c.z),\n"
                   "                     static_cast<float>(c.w));\n"),
        "fillnow": i8_fillnow(SRC),
        **{f"cluster{n}": i8knob("kQCluster", n) for n in (1, 4, 8)},
        **{f"ring{n}": i8knob("kQRing", n) for n in (2, 4)},
        "minblocks1": i8knob("kQMinBlocks", 1),
        "convonly": cut(SRC, *math, "      }\n"),
        "noscores": cut(SRC, "        // 2. the scores",
                        "        // 3. each row's running max",
                        "        __syncthreads();\n"),
        "nophase3": cut(SRC, "        // 3. each row's running max", math[1],
                        "      }\n"),
        "nomath": cut(cut(SRC, *phase1), *math, "      }\n"),
        "empty": sub(SRC, "  const int group = static_cast<int>(cid / a.A);\n",
                     "  if (a.A > 0) return;\n"
                     "  const int group = static_cast<int>(cid / a.A);\n"),
    }


#: the kernel whose build report each variant prints, by cache
REPORT = {"float32": "paged_verify_kernelIffLi128EE",
          "int8": "paged_verify_i8_kernelILi128EE"}


def _so(name, cache):
    return os.path.join(OUT, cache, name, f"lib{pa._LIB}.so")


def build(variants, cache):
    """Every variant's library, built in parallel by the port's nvcc
    command. Stops (non-zero exit) naming every variant that failed to
    build."""
    nvcc, procs = _cuda.nvcc(), {}
    for name, text in variants.items():
        d = os.path.dirname(_so(name, cache))
        os.makedirs(d, exist_ok=True)
        with open(_cuda.source(pa._LIB, d), "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            _cuda.build_command(pa._LIB, _so(name, cache), nvcc, csrc=d),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    failed = []
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            failed.append(f"{name}: nvcc failed\n{log[-3000:]}")
            continue
        use, spills = measure.ptxas_usage(log), measure.ptxas_spills(log)
        # the first design's int8 verify is the float kernel's template
        want = (REPORT[cache], "paged_verify_kernelIfaLi128EE")
        fn = next((f for f in use if want[0] in f), None) or next(
            (f for f in use if want[1] in f), None)
        if fn is not None:
            print(f"  {name} {fn[5:45]}: {use[fn]} registers/smem, spill "
                  f"stores/loads {spills.get(fn)}", flush=True)
    if failed:
        raise SystemExit("\n".join(failed))


def _cases():
    """Each lane's context (None: idle) by case name."""
    return {**{str(ctx): [ctx] * LANES for ctx in CONTEXTS},
            **chip_smoke.verify_mixes()}


def _case(dev, ctxs, cache):
    """The verify's inputs with the window's rows already written (the
    write is idempotent, so every timed call sees the same cache), and the
    int8 cache's scales (None for a float32 cache)."""
    case = list(measure.paged_verify_case(
        dev, [c or 0 for c in ctxs], W, 12, 128, 16, torch.float32,
        active=[c is not None for c in ctxs]))
    scales = None
    if cache == "int8":
        case[3], case[4], ks, vs = measure.int8_cache(case[3], case[4])
        scales = (ks, vs)
    pa.paged_verify_plain(*case, *(scales or ()))
    return case, scales


def first_design(parent):
    """The first design's variant, from the checkout ``parent``."""
    with open(os.path.join(parent, "deeplearning4j_tpu_torch", "csrc",
                           f"{pa._LIB}.cu")) as f:
        return {"v1": f.read()}


def time_variant(name, card, cache):
    """One variant's times at every context (this process loads only its
    library), each with whether its rows are the decode kernel's bits."""
    dev = torch.device("cuda")
    lib = ctypes.CDLL(_so(name, cache))
    for entry, argtypes in pa.ENTRIES.items():
        if hasattr(lib, entry):
            _cuda.declare(getattr(lib, entry), argtypes)
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    res = []
    for label, ctxs in _cases().items():
        case, scales = _case(dev, ctxs, cache)
        q, kn, vn, kc, vc, tab, lane, kmax, win0, wrow, wb, wo = case

        def call():
            return pa._launch(q, kc, vc, tab, lane, kmax, (kn, vn, wb, wo),
                              (win0, wrow), lib=lib, scales=scales)
        ms = measure.median_ms(call, flush)
        got = call()
        dec = pa._launch(q, kc, vc, tab, lane, kmax, (kn, vn, wb, wo),
                         lib=lib, scales=scales)
        torch.cuda.synchronize()
        res.append(f"{label}: {ms:.4f} (rows = decode bits "
                   f"{torch.equal(got, dec)})")
    print(f"  {name} [{cache}]: ms at " + "; ".join(res) + f"  [{card}]",
          flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("paged_verify_study: no CUDA device")
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant")
    ap.add_argument("--only")
    ap.add_argument("--cache", choices=("float32", "int8"),
                    default="float32")
    ap.add_argument("--parent", help="a checkout whose csrc holds the "
                    "first design (adds v1)")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    opts = ap.parse_args()
    if opts.variant:
        return time_variant(opts.variant, card, opts.cache)
    every = {**(first_design(opts.parent) if opts.parent else {}),
             **(i8_variants() if opts.cache == "int8" else VARIANTS)}
    variants = {n: every[n] for n in (opts.only.split(",") if opts.only
                                      else every)}
    t0 = time.perf_counter()
    build(variants, opts.cache)
    print(f"{card}; {len(variants)} variants built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    for label, ctxs in _cases().items():
        case, scales = _case(dev, ctxs, opts.cache)
        q, kn, vn, kc, vc, tab, lane, kmax, win0, wrow, wb, wo = case
        if scales is not None:
            kc, vc = (pa.dequantized(c, s)
                      for c, s in ((kc, scales[0]), (vc, scales[1])))
        qs, dk, dv, mask = measure.paged_verify_library(
            q, kc, vc, tab, lane, kmax, LANES, W)
        lib = measure.median_ms(lambda: F.scaled_dot_product_attention(
            qs, dk, dv, attn_mask=mask), flush)
        _, nbytes = measure.paged_bounds(q, case[3], tab, lane, kmax,
                                         int((wb >= 0).sum()), win0)
        print(f"{label} {ctxs}: library {lib:.4f} ms (masked SDPA over the "
              f"{'dequantised ' if scales else ''}context), bound "
              f"{1e3 * nbytes / 3.35e12:.4f}  [{card}]", flush=True)
    del flush
    failed = []
    for name in variants:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--variant", name, "--cache", opts.cache]
                            ).returncode
        if rc:
            failed.append(name)
    if failed:
        raise SystemExit(f"variants that failed: {failed}")


if __name__ == "__main__":
    main()
