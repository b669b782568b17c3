"""Variants of csrc/paged_attention.cu's cluster decode kernel built side
by side and timed on one card: what each part of its time is.

    python3 experiments/paged_decode_study.py

Each variant is the committed source with one change (a text substitution
below; a substitution whose text the source no longer holds stops the
script before any build), built by the port's nvcc command
(``_cuda.build_command``), all builds started together, into
deeplearning4j_tpu_torch/_build/study_paged/<variant>/; a variant that
does not build stops the script with a non-zero exit. Each is launched
through ``paged_attention._launch`` at GPT-medium decode (8 lanes x 12
heads of 128, float32, blocks of 16, every lane at context 128, 512 and
1024), with and without the step's K/V write. Times are
``kernels/measure.py``'s ``median_ms`` (cold L2, the median of 20 calls
queued behind a device sleep; and, for the base variant, the first kernel
and the library, also after a flush that only reads the 1 GiB buffer, so
that L2 holds no dirty lines whose write-back the timed call pays); each
variant's output is held to the plain version (1e-5 of the sum of the
absolute terms, printed as a share of that tolerance: variants that drop
work are wrong on purpose). The first kernel
(``dl4j_paged_attention_v1``), the library's masked
``F.scaled_dot_product_attention`` over the dense slab and the bound
(bytes over 3.35 TB/s) are printed beside. Each variant is timed in a
process of its own (``--variant NAME``), which loads only its library.
Variants:

- base: the committed source (a ring of one slot a block);
- ring2, ring3, ring4, ring8: rings of that many slots (more copies in
  flight a block, fewer blocks an SM);
- rowcopy: 16-byte cp.async per row instead of one bulk copy a chunk;
- nomath: no scores, softmax or V sums (the copies, waits and combine);
- nocombine: no pushes of the partials and no wait for them (rank 0
  combines what its part_acc holds: what the combine costs);
- empty: the kernel returns at once (a cluster launch of this grid and
  shared memory: the floor);
- no_hint: the K/V copies without their L2 evict-first cache policy.

``--only a,b`` times only those variants.
"""
import argparse
import ctypes
import os
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


def sub(s, a, b, count=1):
    assert s.count(a) == count, a
    return s.replace(a, b)


def nocombine(s):
    s = sub(s, "      st_async(cluster_addr(smem_u32(&part_acc[rank]"
            "[tid * E]), 0), ob, bar);\n", "")
    s = sub(s, "      if (tid == 0) st_async_pair(cluster_addr(smem_u32("
            "&part_ml[rank][0]), 0), mb, lb, bar);\n", "")
    return sub(s, "  mbar_wait(smem_u32(&cbar), 0);\n", "")


VARIANTS = {
    "base": SRC,
    **{f"ring{n}": sub(SRC, "constexpr int kRing = 1;",
                       f"constexpr int kRing = {n};") for n in (2, 3, 4, 8)},
    "rowcopy": sub(SRC, "a.bulk = a.BS % kChunk == 0 && a.skt == D && "
                   "a.svt == D;", "a.bulk = 0;"),
    "nomath": sub(SRC, "      ok[jj] = live && t <= last;",
                  "      ok[jj] = false;"),
    "nocombine": nocombine(SRC),
    "no_hint": sub(sub(
        SRC, 'complete_tx::bytes.L2::cache_hint "\n      "[%0], [%1], %2, '
        '[%3], %4;\\n" ::"r"(dst),\n      "l"(src), "r"(bytes), "r"(bar), '
        '"l"(evict_first())', 'complete_tx::bytes "\n      "[%0], [%1], %2, '
        '[%3];\\n" ::"r"(dst),\n      "l"(src), "r"(bytes), "r"(bar)'),
        'cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\\n" '
        '::"r"(dst),\n               "l"(src), "l"(evict_first())',
        'cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(dst),\n'
        '               "l"(src)'),
    "empty": sub(SRC, "  cg::cluster_group cluster = cg::this_cluster();\n",
                 "  if (a.A > 0) return;\n"
                 "  cg::cluster_group cluster = cg::this_cluster();\n"),
}


def build(variants):
    """Every variant's library, built in parallel by the port's nvcc
    command. Stops (non-zero exit) naming every variant that failed to
    build."""
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
    if failed:
        raise SystemExit("\n".join(failed))


class ReadEvict:
    """A flush for ``median_ms`` whose ``zero_`` reads the buffer instead of
    writing it: L2 is left holding clean lines."""

    def __init__(self, buf):
        self.buf = buf

    def zero_(self):
        self.buf.view(torch.int64).sum()


def _so(name):
    return os.path.join(OUT, name, f"lib{pa._LIB}.so")


def _case(dev, ctx):
    """GPT-medium decode at context ``ctx`` with the step's rows already
    written (the write is idempotent, so every timed call sees the same
    cache): (args of paged_attention, the write, the plain output, its
    absolute terms)."""
    (q, k_new, v_new, kc, vc, tables, lane, kmax, wb,
     wo) = measure.paged_decode_write_case(dev, [ctx - 1] * 8, 12, 128, 16,
                                           torch.float32)
    args = (q, kc, vc, tables, lane, kmax)
    want = pa.paged_decode_plain(q, k_new, v_new, kc, vc, tables, lane,
                                 kmax, wb, wo)
    return args, (k_new, v_new, wb, wo), want, pa.abs_terms(*args)


def time_variant(name, card):
    """One variant's times at every context (this process loads only its
    library)."""
    dev = torch.device("cuda")
    lib = ctypes.CDLL(_so(name))
    for entry, argtypes in pa.ENTRIES.items():
        _cuda.declare(getattr(lib, entry), argtypes)
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    res = []
    for ctx in CONTEXTS:
        args, write, want, terms = _case(dev, ctx)
        ms = measure.median_ms(lambda: pa._launch(*args, lib=lib), flush)
        msw = measure.median_ms(lambda: pa._launch(
            *args, write=write, lib=lib), flush)
        got = pa._launch(*args, lib=lib)
        torch.cuda.synchronize()
        r = measure.paged_reading(got, want, terms, 1e-5)
        res.append(f"{ctx}: {ms:.4f} / {msw:.4f} ({r:.3g})")
        if name == "base":
            ms = measure.median_ms(lambda: pa._launch(
                *args, write=write, lib=lib), ReadEvict(flush))
            res[-1] += f", read flush {ms:.4f}"
    print(f"  {name}: ms without / with the write (share of tol) at context "
          + "; ".join(res) + f"  [{card}]", flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("paged_decode_study: no CUDA device")
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant")
    ap.add_argument("--only")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    opts = ap.parse_args()
    if opts.variant:
        return time_variant(opts.variant, card)
    variants = {n: VARIANTS[n] for n in (opts.only.split(",") if opts.only
                                         else VARIANTS)}
    t0 = time.perf_counter()
    build(variants)
    print(f"{card}; {len(variants)} variants built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    for ctx in CONTEXTS:
        args, _, _, _ = _case(dev, ctx)
        q, kc, vc, tables, lane, kmax = args
        _, nbytes = measure.paged_bounds(q, kc, tables, lane, kmax)
        v1 = measure.median_ms(lambda: measure.paged_attention_v1(*args),
                               flush)
        dk, dv, _ = measure.paged_dense(kc, vc, tables)
        keys = torch.arange(dk.shape[2], device=dev)
        mask = (keys[None, :] <= kmax[:, None].long())[:, None, None, :]
        ql = q.contiguous()[:, :, None, :]
        lib_ms = [measure.median_ms(lambda: F.scaled_dot_product_attention(
            ql, dk, dv, attn_mask=mask), ev) for ev in (flush,
                                                        ReadEvict(flush))]
        v1r = measure.median_ms(lambda: measure.paged_attention_v1(*args),
                                ReadEvict(flush))
        print(f"context {ctx}: bound {1e3 * nbytes / 3.35e12:.4f} ms, "
              f"first kernel {v1:.4f} (read flush {v1r:.4f}), library "
              f"{lib_ms[0]:.4f} (read flush {lib_ms[1]:.4f})  [{card}]",
              flush=True)
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
