"""Variants of csrc/attention_f32.cu built side by side and timed on one
card: what each design choice of the float32 attention kernels is worth.

    python3 experiments/attention_f32_study.py

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

It also prints the SASS instruction mix of the dense head-dim-128 kernel
of each variant (``cuobjdump -sass``).
"""
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
    b = s.index("// The main kernel's shared memory raised past 48 KB")
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


VARIANTS = {
    "base": SRC,
    "cvt_rna": cvt_rna(SRC),
    "naive_combine": naive_combine(SRC),
    "1xtf32": one_tf32(SRC),
    "loads_only": sub(SRC, "    if (!(may_skip && j0 > wmax)) {",
                      "    if (false) {"),
    "compute_only": sub(SRC, "    if (it + 2 < ntiles) {", "    if (false) {"),
    "bn16_3blocks": sub(sub(
        SRC, "static constexpr int BN = D == 128 ? 32 : 64;",
        "static constexpr int BN = D == 128 ? 16 : 64;"),
        "__launch_bounds__(kThreads, 2) attn_f32_kernel",
        "__launch_bounds__(kThreads, 3) attn_f32_kernel"),
    "bn64_1block": sub(sub(
        SRC, "static constexpr int BN = D == 128 ? 32 : 64;",
        "static constexpr int BN = 64;"),
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
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    libs = build(VARIANTS)
    print(f"{card}; {len(libs)} variants built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, (_, so) in libs.items():
        total, top = sass_mix(so)
        print(f"  {name}: blocks an SM at head dim 128: dense "
              f"{af.blocks_per_sm(128, False, lib=libs[name][0])}, paged "
              f"{af.blocks_per_sm(128, True, lib=libs[name][0])}; SASS of "
              f"attn_f32_kernel<128, dense>: {total} "
              f"instructions; " + ", ".join(f"{k} {v}" for k, v in top),
              flush=True)

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
    pq, kc, vc, tables, _, kmax = pargs
    pwant = pa.paged_attention_plain(*pargs)
    pterms = pa.abs_terms(*pargs)
    pout = torch.empty(512, 12, 128, device=dev)
    sc = 1 / math.sqrt(128)
    for name, (lib, _) in libs.items():
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
    lib_ms = measure.median_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), flush)
    print(f"  library F.scaled_dot_product_attention dense: {lib_ms:.4f} ms "
          f"[{card}]", flush=True)


if __name__ == "__main__":
    main()
