"""Variants of csrc/int8_matmul.cu built side by side and timed on one
card: what held the first design back, and what each knob of the
tensor-core design gives.

    python3 experiments/int8_matmul_study.py [--parent DIR]

Each variant is the committed source with one change (a text substitution
below; a substitution whose text the source no longer holds stops the
script before any build), built by the port's nvcc command
(``_cuda.build_command``), all builds started together, into
deeplearning4j_tpu_torch/_build/study_int8/<variant>/; a variant that
does not build stops the script with a non-zero exit. Each is launched
through ``int8_matmul._launch`` at GPT-medium's qkv (x [M, 1536] times w
[1536, 4608]) and tied logits (wte [32768, 1536] read transposed), M = 1,
8, 64 and 512. Times are ``kernels/measure.py``'s ``median_ms`` (cold
L2, the median of 20 calls queued behind a device sleep); each output is
held to the float64 plain version (INT8_TOL, 1e-5 of the sum of the
absolute terms, printed as a share of it: variants that drop work are
wrong on purpose). The library (``torch.matmul`` of x with the dequantised
float32 weight) and the bound (``measure.int8_weight_bound``) are printed
beside. Each variant is timed in a process of its own (``--variant
NAME``), which loads only its library. Variants:

- v1 (with ``--parent DIR``, a checkout of the commit before this design,
  whose ``csrc/int8_matmul.cu`` is the first design under the same entry
  and arguments): the first design (plain FMA, a cluster a 32 x 64 tile,
  the next tile's loads in registers);
- v1_loadonly (with ``--parent``): the first design's grid and loads
  (device memory to registers to shared memory), no products and no
  combine: the bytes in flight alone;
- base: the committed design (wgmma, x in three bf16 pieces, a TMA box
  a weight tile);
- loadonly: its grid, TMA and x copies, no split, widening, products or
  combine;
- nomath: its copies, x loads and combine, no split, widening or
  products;
- nocombine: all but the pushes and their wait (each rank sums what its
  buffer holds: what the cluster exchange costs);
- stages1, stages2, stages4: that many stages a block at every M (the
  committed source: 2 at up to 32 rows a tile, 1 at 64);
- ranks1, ranks2, ranks4, ranks8: the K tiles cut in that many parts
  (blocks a cluster) at every shape (the committed source: 8 below 256
  column tiles, 2 from there on);
- mma8: every product at the MMA's n = 8, whatever M (one width for
  every M);
- rows32: at most 32 rows a tile (two tiles at M = 64);
- empty: the kernel returns at once (a cluster launch of this grid and
  shared memory: the floor).

``--only a,b`` times only those variants.
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
from deeplearning4j_tpu_torch.kernels import _cuda  # noqa: E402
from deeplearning4j_tpu_torch.kernels import int8_matmul as im  # noqa: E402
from deeplearning4j_tpu_torch.kernels import measure  # noqa: E402

OUT = os.path.join(_cuda.PACKAGE, "_build", "study_int8")
SRC = open(_cuda.source(im._LIB)).read()
SHAPES = ((1536, 4608, False), (1536, 32768, True))
MS = (1, 8, 64, 512)
TOL = 1e-5


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


# the tensor-core design's loop: no split (x kept alive), no widening (the
# stage read), no products
_NOMATH = [
    ("    store_x(i);                       // the last tile's products are "
     "done\n",
     "    acc[0] += *reinterpret_cast<const float*>(ring_p + (i % NS) * "
     "St::kBytes + St::kX + 4 * tid);\n"),
    ("    load_a(i);\n",
     "    acc[0] += static_cast<float>(ring_p[(i % NS) * St::kBytes + tid]);"
     "\n")]
_MMA = ("    keep(part);\n    wgmma_fence();\n",
        "    for (int e = 0; e < BM / 2; ++e) acc[e] = __fadd_rn(acc[e], "
        "part[e]);\n")


def nomath(s):
    for a, b in _NOMATH:
        s = sub(s, a, b)
    s = cut(s, *_MMA)
    return sub(s, _MMA[1], "")


def loadonly(s):
    s = nomath(s)
    return cut(s, "  const uint32_t bar = smem_u32(&rbar);\n",
               "// The kernel's shared memory raised past 48 KB",
               "  if (acc[0] == 1234.5f) a.y[0] = acc[0];\n}\n\n")


def nocombine(s):
    return cut(s, "  const uint32_t bar = smem_u32(&rbar);\n",
               "  // this rank's eighths:")


def v1_loadonly(s):
    s = cut(s, "#pragma unroll 8\n    for (int k = 0; k < kBK; ++k) {",
            "  // this rank's partial, then the cluster's eight added",
            "    acc[0][0] += xs[tid % kBK][0] + ws[tid % kBK][0];\n  }\n\n")
    return cut(s, "  // this rank's partial, then the cluster's eight added",
               "bool aligned(const void* p, uintptr_t n) {",
               "  if (acc[0][0] == 1234.5f) a.y[0] = acc[0][0];\n}\n\n")


_STAGES = "  static constexpr int kCount = BM == 64 ? 1 : 2;"
_RANKS = ("inline int ranks_for(int N) { return (N + 63) / 64 >= "
          "kManyTiles ? 2 : 8; }")
_EIGHT = "launch<LAYOUT, BM, 8>(a, st);"
VARIANTS = {
    "base": SRC,
    "loadonly": loadonly(SRC),
    "nomath": nomath(SRC),
    "nocombine": nocombine(SRC),
    **{f"stages{n}": sub(SRC, _STAGES, f"  static constexpr int kCount = {n};")
       for n in (1, 2, 4)},
    "ranks2": sub(SRC, _RANKS, "inline int ranks_for(int) { return 2; }"),
    "ranks8": sub(SRC, _RANKS, "inline int ranks_for(int) { return 8; }"),
    **{f"ranks{n}": sub(sub(SRC, _RANKS, "inline int ranks_for(int) { "
                                         "return 8; }"),
                        _EIGHT, f"launch<LAYOUT, BM, {n}>(a, st);")
       for n in (1, 4)},
    "mma8": sub(SRC, "  constexpr int NW = BM;  ",
                "  constexpr int NW = 8;  "),
    "rows32": sub(SRC, "  return launch_r<LAYOUT, 64>(a, st);\n",
                  "  return launch_r<LAYOUT, 32>(a, st);\n"),
    "empty": sub(SRC, "  const uint32_t dyn0 = smem_u32(dyn);\n",
                 "  if (a.M > 0) return;\n"
                 "  const uint32_t dyn0 = smem_u32(dyn);\n"),
}


def first_design(parent):
    """The first design's variants, from the checkout ``parent``."""
    with open(os.path.join(parent, "deeplearning4j_tpu_torch", "csrc",
                           f"{im._LIB}.cu")) as f:
        src = f.read()
    return {"v1": src, "v1_loadonly": v1_loadonly(src)}


def _so(name):
    return os.path.join(OUT, name, f"lib{im._LIB}.so")


def build(variants):
    """Every variant's library, built in parallel by the port's nvcc
    command. Stops (non-zero exit) naming every variant that failed to
    build."""
    nvcc, procs = _cuda.nvcc(), {}
    for name, text in variants.items():
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        with open(_cuda.source(im._LIB, d), "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            _cuda.build_command(im._LIB, _so(name), nvcc, csrc=d),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    failed = []
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            failed.append(f"{name}: nvcc failed\n{log[-3000:]}")
    if failed:
        raise SystemExit("\n".join(failed))


def time_variant(name, card):
    """One variant's times at every shape and M (this process loads only
    its library)."""
    dev = torch.device("cuda")
    lib = ctypes.CDLL(_so(name))
    _cuda.declare(getattr(lib, im.ENTRY), im.ARGTYPES)
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    for k, n, tr in SHAPES:
        res = []
        for m in MS:
            x, w, s = measure.int8_matmul_case(dev, m, k, n, tr)

            def call():
                return im._launch(x, w, s, tr, lib=lib)
            ms = measure.median_ms(call, flush)
            got = call()
            torch.cuda.synchronize()
            want = im.int8_matmul_plain(x.double(), w, s.double(), tr)
            r = measure.paged_reading(got, want, im.abs_terms(x, w, s, tr),
                                      TOL)
            res.append(f"M {m} {ms:.4f} ({r:.3g})")
        print(f"  {name} {k}x{n}{' wte^T' if tr else ''}: ms (share of tol) "
              + "; ".join(res) + f"  [{card}]", flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("int8_matmul_study: no CUDA device")
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant")
    ap.add_argument("--only")
    ap.add_argument("--parent", help="a checkout whose csrc holds the "
                    "first design (adds v1 and v1_loadonly)")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    opts = ap.parse_args()
    if opts.variant:
        return time_variant(opts.variant, card)
    every = {**(first_design(opts.parent) if opts.parent else {}),
             **VARIANTS}
    variants = {n: every[n] for n in (opts.only.split(",") if opts.only
                                      else every)}
    t0 = time.perf_counter()
    build(variants)
    print(f"{card}; {len(variants)} variants built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    for k, n, tr in SHAPES:
        res = []
        for m in MS:
            x, w, s = measure.int8_matmul_case(dev, m, k, n, tr)
            deq = (w.float() * s).t().contiguous() if tr else w.float() * s
            lib = measure.median_ms(lambda: torch.matmul(x, deq), flush)
            b = measure.int8_weight_bound(*measure.int8_matmul_bounds(
                m, k, n), card)
            res.append(f"M {m} library {lib:.4f}, bound {b['bound_ms']:.4f} "
                       f"({b['bound_by']}), {im.grid_blocks(m, n)} blocks")
        print(f"{k}x{n}{' wte^T' if tr else ''}: " + "; ".join(res)
              + f"  [{card}]", flush=True)
    del flush
    failed = []
    for name in variants:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--variant", name]).returncode
        if rc:
            failed.append(name)
    if failed:
        raise SystemExit(f"variants that failed: {failed}")


if __name__ == "__main__":
    main()
