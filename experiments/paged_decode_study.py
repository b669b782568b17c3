"""Variants of csrc/paged_attention.cu's cluster decode kernel built side
by side and timed on one card: what each part of its time is, over a
float32 cache and over an int8 one.

    python3 experiments/paged_decode_study.py [--parent DIR] [--only a,b]

Each variant is the committed source with one change (a text substitution
below; a substitution whose text the source no longer holds stops the
script before any build), built by the port's nvcc command
(``_cuda.build_command``), all builds started together, into
deeplearning4j_tpu_torch/_build/study_paged/<variant>/; a variant that
does not build stops the script with a non-zero exit. After the builds
each variant's ptxas registers, static shared memory and spills are
printed for the decode kernel <float, float, 128> and <float, int8, 128>,
and, in its timing process, the blocks an SM and the clusters on the card
that the card's occupancy calculator gives them (the library's
``dl4j_paged_decode_occupancy``). Each is launched through
``paged_attention._launch`` at GPT-medium decode (8 lanes x 12 heads of 128, float32, blocks of 16, every
lane at context 128, 512 and 1024): over the float32 cache without and
with the step's K/V write, and over an int8 copy of it (per-(head,
channel) absmax scales) without and with the write. Times are
``kernels/measure.py``'s ``median_ms`` (cold L2, the median of 20 calls
queued behind a device sleep); each output is held to the plain version
(1e-5 of the sum of the absolute terms, printed as a share of that
tolerance: variants that drop work are wrong on purpose). The library's
masked ``F.scaled_dot_product_attention`` over the dense slab and the
bound (bytes over 3.35 TB/s, float32 and int8) are printed beside. Each
variant is timed in a process of its own (``--variant NAME``), which
loads only its library. Variants:

- v1 (with ``--parent DIR``, a checkout of the commit before the int8
  design, whose ``csrc/paged_attention.cu`` has the same entries): the
  first int8 design (a ring of one slot, each element dequantised as the
  math reads it);
- base: the committed source;
- ring2, ring3, ring4, ring8: rings of that many slots, over both caches
  (more copies in flight a block, fewer blocks an SM; over an int8 cache
  four slots put every chunk a rank owns in flight up to context 512);
- scaleloads: the int8 kernel without the scales folded out of the inner
  loop (a scale load and a multiply a key element, as the first design);
- rowcopy: 16-byte cp.async per row instead of one bulk copy a chunk;
- nomath: no scores, softmax or V sums (the copies, waits and combine);
- nocombine: no pushes of the partials and no wait for them (rank 0
  combines what its part_acc holds: what the combine costs);
- empty: the decode kernel returns at once (a cluster launch of this grid
  and shared memory: the floor);
- no_hint: the K/V copies without their L2 evict-first cache policy.

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

OUT = os.path.join(_cuda.PACKAGE, "_build", "study_paged")
SRC = open(_cuda.source(pa._LIB)).read()
CONTEXTS = (128, 512, 1024)
#: the decode kernels whose build report is printed, by label
KERNELS = {"float": "paged_decode_kernelIffLi128EE",
           "int8": "paged_decode_kernelIfaLi128EE"}


def sub(s, a, b, count=1):
    assert s.count(a) == count, a
    return s.replace(a, b)


def nocombine(s):
    s = sub(s, "      st_async(cluster_addr(smem_u32(&part_acc[rank]"
            "[tid * E]), 0), ob, bar);\n", "")
    s = sub(s, "      if (tid == 0) st_async_pair(cluster_addr(smem_u32("
            "&part_ml[rank][0]), 0), mb, lb, bar);\n", "")
    return sub(s, "(kRanks - 1) * (D + 2) * static_cast<uint32_t>(sizeof(T)));"
               "\n  __syncthreads();\n  mbar_wait(smem_u32(&cbar), 0);\n",
               "(kRanks - 1) * (D + 2) * static_cast<uint32_t>(sizeof(T)));"
               "\n  __syncthreads();\n")


def no_policy(s):
    """The bulk copies (two the decode's, three the float verify's, two the
    int8 verify's) without the evict-first policy: sm90.cuh's bulk_load
    without its policy."""
    pat = r",\s*evict_first\(\)\);"
    assert len(re.findall(pat, s)) == 7
    return re.sub(pat, ");", s)


def knob(name, value, src=SRC):
    """The source with ``constexpr int name = <n>;`` set to ``value``."""
    old = re.search(rf"constexpr int {name} = (\d+);", src).group(0)
    return sub(src, old, f"constexpr int {name} = {value};")


VARIANTS = {
    "base": SRC,
    **{f"ring{n}": knob("kRing", n) for n in (2, 3, 4, 8)},
    "scaleloads": sub(SRC, "static constexpr bool kFold = sizeof(C) == 1 "
                      "&& sizeof(T) == 4;", "static constexpr bool kFold = "
                      "false;"),
    "rowcopy": sub(SRC, "a.bulk = a.BS % kChunk == 0 && a.skt == D && "
                   "a.svt == D;", "a.bulk = 0;"),
    "nomath": sub(SRC, "      ok[jj] = live && t <= last;",
                  "      ok[jj] = false;"),
    "nocombine": nocombine(SRC),
    "no_hint": sub(no_policy(SRC),
        'cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\\n" '
        '::"r"(dst),\n               "l"(src), "l"(evict_first())',
        'cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(dst),\n'
        '               "l"(src)'),
    "empty": sub(SRC, "  const int64_t cid = blockIdx.x / kRanks;    "
                 "// the (row, head) of the cluster\n",
                 "  if (a.A > 0) return;\n"
                 "  const int64_t cid = blockIdx.x / kRanks;    "
                 "// the (row, head) of the cluster\n"),
}


def _so(name):
    return os.path.join(OUT, name, f"lib{pa._LIB}.so")


def _load(name):
    """A variant's library, its entries declared (a first design may lack
    the occupancy entry)."""
    lib = ctypes.CDLL(_so(name))
    for entry, argtypes in pa.ENTRIES.items():
        if hasattr(lib, entry):
            _cuda.declare(getattr(lib, entry), argtypes)
    return lib


def build(variants):
    """Every variant's library, built in parallel by the port's nvcc
    command; prints each one's decode kernels' registers, static shared
    memory and spills (ptxas's report). Stops (non-zero exit) naming every
    variant that failed to build."""
    nvcc, procs = _cuda.nvcc(), {}
    for name, text in variants.items():
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        with open(_cuda.source(pa._LIB, d), "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            _cuda.build_command(pa._LIB, _so(name), nvcc, csrc=d),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    failed = []
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            failed.append(f"{name}: nvcc failed\n{log[-3000:]}")
            continue
        use, spills = measure.ptxas_usage(log), measure.ptxas_spills(log)
        parts = []
        for label, tag in KERNELS.items():
            fn = next((k for k in use if tag in k), None)
            if fn is None:
                parts.append(f"{label}: not in the report")
                continue
            regs, smem = use[fn]
            parts.append(f"{label}: {regs} registers, {smem} B static "
                         f"shared, spills {spills.get(fn)}")
        print(f"  {name} <float, ..., 128>: " + "; ".join(parts), flush=True)
    if failed:
        raise SystemExit("\n".join(failed))


class ReadEvict:
    """A flush for ``median_ms`` whose ``zero_`` reads the buffer instead of
    writing it: L2 is left holding clean lines."""

    def __init__(self, buf):
        self.buf = buf

    def zero_(self):
        self.buf.view(torch.int64).sum()


def _case(dev, ctx, int8):
    """GPT-medium decode at context ``ctx`` with the step's rows already
    written (the write is idempotent, so every timed call sees the same
    cache), over the float32 cache or an int8 copy of it: (args of
    ``_launch``, the write, the scales or None, the plain output, its
    absolute terms)."""
    (q, k_new, v_new, kc, vc, tables, lane, kmax, wb,
     wo) = measure.paged_decode_write_case(dev, [ctx - 1] * 8, 12, 128, 16,
                                           torch.float32)
    scales = None
    if int8:
        kc, vc, ks, vs = measure.int8_cache(kc, vc)
        scales = (ks, vs)
    args = (q, kc, vc, tables, lane, kmax)
    want = pa.paged_decode_plain(q, k_new, v_new, kc, vc, tables, lane,
                                 kmax, wb, wo, *(scales or ()))
    return (args, (k_new, v_new, wb, wo), scales, want,
            pa.abs_terms(*args, *(scales or ())))


def time_variant(name, card):
    """One variant's times at every context, over the float32 and the int8
    cache (this process loads only its library)."""
    dev = torch.device("cuda")
    lib = _load(name)
    # here, where the process holds no other variant: the decode kernel's
    # once-a-device attribute record is one symbol that every library
    # loaded in a process shares
    if hasattr(lib, pa.OCCUPANCY_ENTRY):
        occ = [pa.decode_occupancy(128, torch.float32, int8, lib=lib)
               for int8 in (False, True)]
        print(f"  {name} <float, ..., 128>: blocks an SM, clusters on the "
              f"card: float32 cache {occ[0][0]}, {occ[0][1]}; int8 cache "
              f"{occ[1][0]}, {occ[1][1]}  [{card}]", flush=True)
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    for int8 in (False, True):
        res = []
        for ctx in CONTEXTS:
            args, write, scales, want, terms = _case(dev, ctx, int8)
            ms = measure.median_ms(lambda: pa._launch(
                *args, lib=lib, scales=scales), flush)
            msw = measure.median_ms(lambda: pa._launch(
                *args, write=write, lib=lib, scales=scales), flush)
            got = pa._launch(*args, write=write, lib=lib, scales=scales)
            torch.cuda.synchronize()
            r = measure.paged_reading(got, want, terms, 1e-5)
            res.append(f"{ctx}: {ms:.4f} / {msw:.4f} ({r:.3g})")
        print(f"  {name} {'int8' if int8 else 'float32'} cache: ms without "
              f"/ with the write (share of tol) at context "
              + "; ".join(res) + f"  [{card}]", flush=True)


def first_design(parent):
    """The first int8 design's variant, from the checkout ``parent``."""
    with open(os.path.join(parent, "deeplearning4j_tpu_torch", "csrc",
                           f"{pa._LIB}.cu")) as f:
        return {"v1": f.read()}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("paged_decode_study: no CUDA device")
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant")
    ap.add_argument("--only")
    ap.add_argument("--parent", help="a checkout whose csrc holds the "
                    "first int8 design (adds v1)")
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
    for ctx in CONTEXTS:
        args, _, _, _, _ = _case(dev, ctx, False)
        q, kc, vc, tables, lane, kmax = args
        kc8 = measure.int8_cache(kc, vc)[0]
        bounds = [measure.paged_bounds(q, c, tables, lane, kmax)[1]
                  / 3.35e12 * 1e3 for c in (kc, kc8)]
        dk, dv, _ = measure.paged_dense(kc, vc, tables)
        keys = torch.arange(dk.shape[2], device=dev)
        mask = (keys[None, :] <= kmax[:, None].long())[:, None, None, :]
        ql = q.contiguous()[:, :, None, :]
        lib_ms = [measure.median_ms(lambda: F.scaled_dot_product_attention(
            ql, dk, dv, attn_mask=mask), ev) for ev in (flush,
                                                        ReadEvict(flush))]
        print(f"context {ctx}: bound {bounds[0]:.4f} ms (int8 cache "
              f"{bounds[1]:.4f}), library {lib_ms[0]:.4f} (read flush "
              f"{lib_ms[1]:.4f})  [{card}]", flush=True)
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
