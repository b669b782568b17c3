"""Variants of csrc/attention_f32.cu built side by side and timed on one
card: what each design choice of the float32 attention kernels, and of the
paged prefill over an int8 cache, is worth.

    python3 experiments/attention_f32_study.py [--parent DIR] [--only a,b]

Each variant is the committed source with one change (a text substitution
below; a substitution whose text the source no longer holds stops the
script before any build), built by the port's nvcc command
(``_cuda.build_command``), all builds started together, into
deeplearning4j_tpu_torch/_build/study_f32/<variant>/; a variant that does
not build stops the script with a non-zero exit. Each is called through the wrappers'
launch functions at the two serving shapes: the dense prefill's forward
(1, 12, 512, 128) causal, and the paged prefill of 512 rows after 256
cached keys (12 heads of 128, blocks of 16), each at several work-item
sizes (``chunk`` keys). Times are ``kernels/measure.py``'s ``median_ms``
(cold L2, the median of 20 calls queued behind a device sleep); each
variant's output is held to the plain version (1e-5 of the sum of the
absolute terms, printed as a share of that tolerance: variants that drop
work are wrong on purpose). Variants:

- base: the committed source;
- cvt_rna: hi and lo rounded by cvt.rna.tf32.f32 instead of integer ops;
- naive_combine: the combining launch as one block a tile, a thread an
  element at a time (each iteration's loads wait on the last);
- 1xtf32: one TF32 product instead of three (the split's and the two
  small products' cost);
- loads_only / compute_only: no products and softmax / no key-tile loads
  after the first two (what the memory side and the arithmetic side cost
  alone);
- bn16_3blocks: 16-key tiles at head dim 128, three blocks an SM;
- bn64_1block: 64-key tiles at head dim 128, one block an SM.

The int8 prefill (``prefill_i8_kernel``) is timed at the paged serving
shape over an int8 copy of the cache (per-(head, channel) absmax scales),
at several work-item sizes, in these variants (and in base):

- i8_v1 (with ``--parent DIR``, a checkout of the commit before the int8
  design, whose ``dl4j_paged_prefill_f32`` takes the same arguments): the
  first design, the float engine with int8 tiles loaded synchronously and
  dequantised into the float32 tile;
- i8_loads: the bulk copies and their waits alone (no bf16 tiles, no
  products, no softmax);
- i8_nomath: the copies and the bf16 tiles, no products and no softmax;
- i8_stages2: two int8 stages instead of one (one block an SM at head
  dim 128);
- i8_bn32_stages4: 32-key tiles at head dim 128 in a ring of four stages
  (two blocks an SM).

Base and i8_bn32_stages4 are also timed at six prefill shapes of the
serving traffic (hist 0 and 256 cached keys, 64-502 rows) at the work
split the wrapper picks, base also at work items of at least 256 keys.

It also prints the SASS instruction mix of the dense head-dim-128 kernel
of each variant, and the wgmma, bulk copy and mbarrier wait counts of the
int8 kernel at head dim 128 (``cuobjdump -sass``).
"""
import argparse
import ctypes
import math
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
from deeplearning4j_tpu_torch.kernels import attention as at  # noqa: E402
from deeplearning4j_tpu_torch.kernels import attention_f32 as af  # noqa
from deeplearning4j_tpu_torch.kernels import measure  # noqa: E402
from deeplearning4j_tpu_torch.kernels import paged_attention as pa  # noqa

OUT = os.path.join(_cuda.PACKAGE, "_build", "study_f32")
SRC = open(_cuda.source("attention_f32")).read()


def sub(s, a, b):
    assert a in s, a
    return s.replace(a, b)


def cvt_rna(s):
    return sub(s, '''  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));''', '''  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));''')


NAIVE = '''  const float* pb = a.part + (bh * a.tiles + tile) * a.ncmax * kItem;
  float* ob = a.out + b * a.ob + h * a.oh;
  for (int e = threadIdx.x; e < kBM * D; e += kThreads) {
    const int r = e / D, c = e % D;
    if (q0 + r >= a.rows) break;
    const float* ml = pb + kBM * D + 2 * r;
    float mx = -INFINITY;
    for (int i = 0; i < nitems; ++i) mx = fmaxf(mx, ml[i * kItem]);
    float l = 0.f, acc = 0.f;
    if (mx != -INFINITY)
      for (int i = 0; i < nitems; ++i) {
        const float w = ex2(ml[i * kItem] - mx);
        l += w * ml[i * kItem + 1];
        acc += w * pb[i * kItem + r * D + c];
      }
    ob[(q0 + r) * a.os + c] = l > 0.f ? acc / l : 0.f;
    if (!PAGED && c == 0) {
      float* st = a.stats + (bh * a.rows + q0 + r) * 2;
      st[0] = mx;
      st[1] = log2f(l);
    }
  }
}
'''


def naive_combine(s):
    s = sub(s, "  const int tile = blockIdx.x / (kBM / kCombineRows);",
            "  const int tile = blockIdx.x;")
    s = sub(s, "  const int r0 = (blockIdx.x % (kBM / kCombineRows)) * "
            "kCombineRows;\n", "")
    a = s.index("  const float* pb = a.part + (bh * a.tiles + tile) * "
                "a.ncmax * kItem;")
    b = s.index("// ------------------------------------------------------"
                "---------------------\n// The paged prefill over an int8 "
                "cache")
    s = s[:a] + NAIVE + "\n" + s[b:]
    return sub(s, "dim3(static_cast<unsigned>(a.tiles * (kBM / kCombineRows))",
               "dim3(static_cast<unsigned>(a.tiles)")


def one_tf32(s):
    s = sub(s, "          mma(ss[n], al, bh_);\n          mma(ss[n], ah, bl_);\n",
            "")
    s = sub(s, "  mma(c, al, bh);\n  mma(c, ah, bl);\n", "")
    return sub(s, '''  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));''',
               "  hi = __float_as_uint(x);\n  lo = 0u;")


def i8_skip(s, what):
    """The int8 kernel without its math (and, for ``loads``, without its
    bf16 tiles): each tile still waits on its copies and issues the next."""
    s = sub(s, "    if (warp == 0 && it + NS < ntiles) issue(it + NS);\n",
            "    if (warp == 0 && it + NS < ntiles) issue(it + NS);\n"
            "    if (a.rows > 0) continue;\n")
    if what == "loads":
        s = sub(s, "    for (int idx = tid; idx < 2 * BN * (D / 16); "
                "idx += kThreads) {",
                "    for (int idx = tid; idx < 2 * BN * (D / 16) && "
                "a.rows < 0; idx += kThreads) {")
    return s


INT8_VARIANTS = {
    "i8_loads": i8_skip(SRC, "loads"),
    "i8_nomath": i8_skip(SRC, "math"),
    "i8_stages2": sub(SRC, "constexpr int kI8Stages = 1;",
                      "constexpr int kI8Stages = 2;"),
    "i8_bn32_stages4": sub(sub(
        SRC, "static constexpr int BN = 64;                      // keys a "
        "tile", "static constexpr int BN = D == 128 ? 32 : 64;      // keys "
        "a tile"), "constexpr int kI8Stages = 1;",
        "constexpr int kI8Stages = 4;"),
}

VARIANTS = {
    "base": SRC,
    "cvt_rna": cvt_rna(SRC),
    "naive_combine": naive_combine(SRC),
    "1xtf32": one_tf32(SRC),
    "loads_only": sub(SRC, "    if (!(may_skip && j0 > wmax)) {",
                      "    if (false) {"),
    "compute_only": sub(SRC, "    if (it + 2 < ntiles) {", "    if (false) {"),
    "bn16_3blocks": sub(sub(
        SRC, "int BN = D == 128 ? 32 : 64;   // keys of a K/V tile",
        "int BN = D == 128 ? 16 : 64;   // keys of a K/V tile"),
        "__launch_bounds__(kThreads, 2) attn_f32_kernel",
        "__launch_bounds__(kThreads, 3) attn_f32_kernel"),
    "bn64_1block": sub(sub(
        SRC, "int BN = D == 128 ? 32 : 64;   // keys of a K/V tile",
        "int BN = 64;   // keys of a K/V tile"),
        "__launch_bounds__(kThreads, 2) attn_f32_kernel",
        "__launch_bounds__(kThreads, 1) attn_f32_kernel"),
}


def build(variants):
    """Every variant's library, built in parallel by the port's nvcc
    command: name -> (CDLL, path). Stops (non-zero exit) naming every
    variant that failed to build."""
    nvcc, procs = _cuda.nvcc(), {}
    for name, text in variants.items():
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        with open(_cuda.source(af._LIB, d), "w") as f:
            f.write(text)
        so = os.path.join(d, f"lib{af._LIB}.so")
        procs[name] = (subprocess.Popen(
            _cuda.build_command(af._LIB, so, nvcc, csrc=d),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs, failed = {}, []
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            failed.append(f"{name}: nvcc failed\n{log[-3000:]}")
            continue
        lib = ctypes.CDLL(so)
        for entry, argtypes in af.ENTRIES.items():
            _cuda.declare(getattr(lib, entry), argtypes)
        libs[name] = (lib, so)
    if failed:
        raise SystemExit("\n".join(failed))
    return libs


def i8_sass(so):
    """wgmma, bulk copy and mbarrier wait counts of the int8 kernel at head
    dim 128, and whether any mma.sync is left in it."""
    body = next((b for k, b in measure.sass_kernels(so).items()
                 if "prefill_i8_kernelILi128E" in k), None)
    if body is None:
        return "no prefill_i8_kernel<128>"
    return (f"HGMMA {body.count('HGMMA.')}, UBLKCP {body.count('UBLKCP')}, "
            f"SYNCS.PHASECHK {body.count('SYNCS.PHASECHK')}, HMMA "
            f"{body.count('HMMA')}")


def sass_mix(so):
    body = next(b for k, b in measure.sass_kernels(so).items()
                if "attn_f32_kernelILi128ELb0" in k)
    ops = {}
    for line in body.splitlines():
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                      line)
        if m:
            ops[m.group(1)] = ops.get(m.group(1), 0) + 1
    return sum(ops.values()), sorted(ops.items(), key=lambda kv: -kv[1])[:8]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("attention_f32_study: no CUDA device")
    ap = argparse.ArgumentParser()
    ap.add_argument("--only")
    ap.add_argument("--parent", help="a checkout whose csrc holds the "
                    "first int8 prefill design (adds i8_v1)")
    opts = ap.parse_args()
    int8 = dict(INT8_VARIANTS)
    if opts.parent:
        with open(os.path.join(opts.parent, "deeplearning4j_tpu_torch",
                               "csrc", f"{af._LIB}.cu")) as f:
            int8 = {"i8_v1": f.read(), **int8}
    every = {**VARIANTS, **int8}
    if opts.only:
        every = {n: every[n] for n in opts.only.split(",")}
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    libs = build(every)
    print(f"{card}; {len(libs)} variants built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, (lib, so) in libs.items():
        total, top = sass_mix(so)
        print(f"  {name}: blocks an SM at head dim 128: dense "
              f"{af.blocks_per_sm(128, 'dense', lib=lib)}, paged "
              f"{af.blocks_per_sm(128, 'paged', lib=lib)}, paged int8 "
              f"{af.blocks_per_sm(128, 'paged_i8', lib=lib)}; SASS of "
              f"attn_f32_kernel<128, dense>: {total} "
              f"instructions; " + ", ".join(f"{k} {v}" for k, v in top)
              + f"; prefill_i8_kernel<128>: {i8_sass(so)}", flush=True)

    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=dev).manual_seed(0)
    qkv = torch.randn(1, 512, 12, 3 * 128, device=dev,
                      generator=g).permute(0, 2, 1, 3)
    q, k, v = torch.split(qkv, 128, dim=3)
    do = torch.randn(1, 12, 512, 128, device=dev, generator=g)
    t_o = at.abs_terms(q, k, v, do, True)[0]
    want, _ = at.attention_fwd_plain(q, k, v, True)
    out = torch.empty(1, 12, 512, 128, device=dev)
    stats = torch.empty(1, 12, 512, 2, device=dev)
    pargs = measure.paged_prefill_case(dev, 256, 512, 512, 12, 128, 16,
                                       torch.float32)
    pq, kc, vc, tables, lane, kmax = pargs
    pwant = pa.paged_attention_plain(*pargs)
    pterms = pa.abs_terms(*pargs)
    kc8, vc8, ks, vs = measure.int8_cache(kc, vc)
    i8args = (pq, kc8, vc8, tables, lane, kmax, ks, vs)
    i8want = pa.paged_attention_plain(*i8args)
    i8terms = pa.abs_terms(*i8args)
    pout = torch.empty(512, 12, 128, device=dev)
    sc = 1 / math.sqrt(128)
    for name, (lib, _) in libs.items():
        if name in int8:
            continue
        res = []
        for ch in (64, 128, 192, 256, 512):
            part = torch.empty(max(af.partial_floats(12, 512, 512, ch, 128),
                                   1), device=dev)

            def fn():
                af.launch_fwd(q, k, v, out, stats, part, sc, True, ch,
                              stream, lib=lib)
            ms = measure.median_ms(fn, flush)
            fn()
            torch.cuda.synchronize()
            r = float(((out.double() - want.double()).abs()
                       / (1e-5 * t_o)).max())
            res.append(f"{ch}: {ms:.4f} ({r:.3g})")
        print(f"  {name}: dense (1, 12, 512, 128) causal, ms (share of tol) "
              f"by chunk: " + "; ".join(res), flush=True)
        res = []
        for ch in (128, 192, 256, 384, 1024):
            part = torch.empty(max(af.partial_floats(12, 512, 1024, ch, 128),
                                   1), device=dev)

            def fn():
                af.launch_prefill(pq, kc, vc, tables[0], kmax, pout, part,
                                  sc, ch, stream, lib=lib)
            ms = measure.median_ms(fn, flush)
            fn()
            torch.cuda.synchronize()
            r = measure.paged_reading(pout, pwant, pterms, 1e-5)
            res.append(f"{ch}: {ms:.4f} ({r:.3g})")
        print(f"  {name}: paged 512 rows after 256, ms (share of tol) by "
              f"chunk: " + "; ".join(res), flush=True)
    for name, (lib, _) in libs.items():
        if name != "base" and name not in int8:
            continue
        res = []
        for ch in (128, 192, 256, 384, 1024):
            part = torch.empty(max(af.partial_floats(12, 512, 1024, ch, 128),
                                   1), device=dev)

            def fn():
                af.launch_prefill(pq, kc8, vc8, tables[0], kmax, pout, part,
                                  sc, ch, stream, ks, vs, lib=lib)
            ms = measure.median_ms(fn, flush)
            fn()
            torch.cuda.synchronize()
            r = measure.paged_reading(pout, i8want, i8terms, 1e-5)
            res.append(f"{ch}: {ms:.4f} ({r:.3g})")
        print(f"  {name}: paged int8 512 rows after 256, ms (share of tol) "
              f"by chunk: " + "; ".join(res) + f"  [{card}]", flush=True)
    # the int8 prefill at prefill shapes of the serving traffic: base and
    # the ring of four 32-key tiles at the work split the wrapper picks,
    # base also at work items of at least 256 keys (four of its tiles)
    for hist, rows in ((0, 64), (0, 128), (0, 300), (0, 502), (256, 64),
                       (256, 256)) if "base" in libs else ():
        args = measure.paged_prefill_case(dev, hist, rows, rows, 12, 128, 16,
                                          torch.float32)
        q_, kc_, vc_, tab_, lane_, km_ = args
        k8, v8, s8k, s8v = measure.int8_cache(kc_, vc_)
        reach = k8.shape[2] * tab_.shape[1]
        want_ = pa.paged_attention_plain(q_, k8, v8, tab_, lane_, km_, s8k,
                                         s8v)
        terms_ = pa.abs_terms(q_, k8, v8, tab_, lane_, km_, s8k, s8v)
        out_ = torch.empty_like(want_)
        split = af.chunk_keys(af.paged_tile_keys(km_.cpu().numpy(), reach),
                              12, af.slots(dev.index, 128, "paged_i8"))
        res = []
        for name, ch in (("base", split), ("base", max(split, 256)),
                         ("i8_bn32_stages4", split)):
            if name not in libs:
                continue
            part = torch.empty(max(af.partial_floats(12, rows, reach, ch,
                                                     128), 1), device=dev)

            def fn():
                af.launch_prefill(q_, k8, v8, tab_[0], km_, out_, part, sc,
                                  ch, stream, s8k, s8v, lib=libs[name][0])
            ms = measure.median_ms(fn, flush)
            fn()
            torch.cuda.synchronize()
            r = measure.paged_reading(out_, want_, terms_, 1e-5)
            res.append(f"{name} at {ch}: {ms:.4f} ({r:.3g})")
        print(f"  paged int8 {rows} rows after {hist}, ms (share of tol) by "
              f"variant and chunk (the wrapper's split {split}): "
              + "; ".join(res) + f"  [{card}]", flush=True)
    lib_ms = measure.median_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), flush)
    print(f"  library F.scaled_dot_product_attention dense: {lib_ms:.4f} ms "
          f"[{card}]", flush=True)


if __name__ == "__main__":
    main()
