"""Tile-size variants of the bf16 attention kernels, on the card.

    python3 experiments/cuda_attention_study.py

Builds ``deeplearning4j_tpu_torch/csrc/causal_attention.cu`` once per
variant (design alternatives: tile sizes, ring depths, setmaxnreg) and per
ablation of the forward (parts removed, timing only), each a text edit of
the source ("kept" is the source as it is), all builds started together,
under ``deeplearning4j_tpu_torch/_build/study_attn/``, and prints ptxas's
registers and spills and the SASS's HGMMA, UTMALDG and WARPGROUP.DEPBAR
counts of each one's D = 128 kernels. Then, at
GPT-medium's attention shape (16, 12, 512, 128) bf16 causal with
build_gpt's split views, each variant's forward, dk/dv and dq kernels are
held to their plain versions (2^-6 of the sum of absolute terms, as
``chip_smoke.py`` holds them) and timed as ``chip_smoke.py`` times them
(``kernels/measure.py``'s ``median_ms``: the median of 20 calls, each
after a 1 GiB write, queued behind a device sleep), beside
``F.scaled_dot_product_attention(is_causal=True)`` forward and backward
timed the same way. Prints one table, with the card's name and power
limit. Imports nothing of JAX.

Each variant is a text edit of the source as it stands: an edit whose
text the source no longer holds stops the script before any build.
"""
import ctypes
import math
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from deeplearning4j_tpu_torch.environment import card_info  # noqa: E402
from deeplearning4j_tpu_torch.kernels import _cuda  # noqa: E402
from deeplearning4j_tpu_torch.kernels import attention as at  # noqa: E402
from deeplearning4j_tpu_torch.kernels import measure  # noqa: E402

#: GPT-medium's attention per call: batch, heads, sequence, head dim
SHAPE = (16, 12, 512, 128)

MROW = "      float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};\n"
#: the forward's tile loop with the next tile's S issued before this
#: tile's softmax (needs a second score fragment: 64-key tiles)
NEXT_S = MROW + r"""
      float sc[BN / 2], sn[BN / 2];
      if (ntiles > 0) {
        mbar_wait(full_bar(bars, g % ST), (g / ST) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<BN>::ss(sc, desc_k<D, BM>(qs, wg * 64, kk),
                        desc_k<D, BN>(ring + (g % ST) * 2 * C::kKV, 0, kk), kk > 0);
        wgmma_commit();
        wgmma_wait();
        keep(sc);
      }
      for (int it = 0; it < ntiles; ++it, ++g) {
        const int s = g % ST;
        const int64_t k0 = static_cast<int64_t>(it) * BN;
        const uint32_t vt = ring + s * 2 * C::kKV + C::kKV;
        if (it + 1 < ntiles) {
          const int s1 = (g + 1) % ST;
          mbar_wait(full_bar(bars, s1), ((g + 1) / ST) & 1);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            Wgmma<BN>::ss(sn, desc_k<D, BM>(qs, wg * 64, kk),
                          desc_k<D, BN>(ring + s1 * 2 * C::kKV, 0, kk), kk > 0);
          wgmma_commit();
        }
        const bool edge = k0 + BN > sk || k0 + BN - 1 > lim_lo;
        mask_scores<BN>(sc, lim, static_cast<int>(k0) + 2 * t, sk, scale2, edge);
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float mnew = fmaxf(mrow[r], quad_max(mx[r]));
          corr[r] = ex2(mrow[r] - mnew);
          mrow[r] = mnew;
        }
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int r = (i >> 1) & 1;
          sc[i] = ex2(sc[i] - mrow[r]);
          rs[r] += sc[i];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) lrow[r] = lrow[r] * corr[r] + rs[r];
        if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
          for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
        }
        uint32_t pa[BN / 16][4];
        to_a<BN>(pa, sc);
        keep(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) Wgmma<D>::rs(o, pa[kk], desc_mn<D, BN>(vt, kk));
        wgmma_commit();
        wgmma_wait();
        keep(o);
        keep(pa);
        keep(sn);
        if (tid == 0) mbar_arrive(empty_bar(bars, s));
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) sc[i] = sn[i];
      }

"""
FWD_CFG = "static constexpr int BM = 128, BN = 128, ST = 2;"
DQ_CFG = "static constexpr int BM = 128, BK = 64, ST = 3;"
DKDV_CFG = "static constexpr int BK = 64, BQ = 64, ST = 3;"
#: design alternatives to the kept source, as text edits of it (each is
#: held to the plain versions like the kept one)
VARIANTS = {
    "kept": [],
    "no setmaxnreg": [
        ('asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\\n" ::: "memory");', ""),
        ('asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\\n" ::: "memory");', "")],
    "bwd 2 stages": [(DQ_CFG, DQ_CFG.replace("ST = 3", "ST = 2")),
                     (DKDV_CFG, DKDV_CFG.replace("ST = 3", "ST = 2"))],
    "dkdv BQ 32": [(DKDV_CFG, DKDV_CFG.replace("BQ = 64", "BQ = 32"))],
    "fwd BN 64, 3 stages": [(FWD_CFG, FWD_CFG.replace("BN = 128, ST = 2",
                                                      "BN = 64, ST = 3"))],
    "fwd BN 64, 3 stages, next S": [
        (FWD_CFG, FWD_CFG.replace("BN = 128, ST = 2", "BN = 64, ST = 3")),
        (MROW, "      // O = o / l through", NEXT_S)],
}
PV_CALL = ("for (int kk = 0; kk < BN / 16; ++kk) Wgmma<D>::rs(o, pa[kk], "
           "desc_mn<D, BN>(vt, kk));")
Q_LOAD = ("mbar_expect_tx(rf, C::kQ);\n"
          "        load_tile<D, BM>(base + (n & 1) * C::kQ, p.tq, rf, q0, h, b);")
KV_LOAD = ("mbar_expect_tx(fb, 2 * C::kKV);\n"
           "          load_tile<D, BN>(kt, p.tk, fb, static_cast<int64_t>(it) * BN, h, b);\n"
           "          load_tile<D, BN>(kt + C::kKV, p.tv, fb, static_cast<int64_t>(it) * BN, "
           "h, b);")
EXP = "sc[i] = ex2(sc[i] - mrow[r]);"
STORE = "      store_rows<D, BM>(static_cast<uint16_t*>(a.out)"
#: ablations of the kept forward (timing only: their results are wrong by
#: design); an edit (start, end, new) replaces the text from start up to end
ABLATIONS = {
    "fwd no PV": [(PV_CALL, "")],
    "fwd no TMA": [(Q_LOAD, "mbar_arrive(rf);"), (KV_LOAD, "mbar_arrive(fb);")],
    "fwd no exp2": [(EXP, "sc[i] = sc[i] - mrow[r];")],
    "fwd no softmax": [("        // mask only the tiles", "        uint32_t pa[BN / 16][4];",
                        "")],
    "fwd no O store": [(STORE, "      if (a.D < 0) store_rows<D, BM>("
                               "static_cast<uint16_t*>(a.out)")],
}
KERNELS = ("attention_fwd", "attention_bwd_delta", "attention_bwd_dkdv",
           "attention_bwd_dq")


def build(variants, ablations):
    """Every variant's and ablation's library, built in parallel: name ->
    (CDLL, ptxas lines of its D = 128 bf16 kernels)."""
    src = open(_cuda.source("causal_attention")).read()
    procs = {}
    for name, edits in {**variants, **ablations}.items():
        d = os.path.join(_cuda.PACKAGE, "_build", "study_attn",
                         name.replace(" ", "_").replace("/", "_"))
        os.makedirs(d, exist_ok=True)
        text = src
        for edit in edits:
            if len(edit) == 3:   # (start, end, new): the text from start to end
                start, end, new = edit
                i = text.index(start)
                edit = (text[i:text.index(end, i)], new)
            old, new = edit
            assert old in text, old
            text = text.replace(old, new)
        with open(os.path.join(d, "causal_attention.cu"), "w") as f:
            f.write(text)
        out = os.path.join(d, "lib.so")
        procs[name] = (subprocess.Popen(
            _cuda.build_command("causal_attention", out, _cuda.nvcc(), csrc=d),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        lines, fn = [], None
        for line in log.splitlines():
            if "Function properties for" in line:
                fn = line.split()[-1]
            elif fn and "bf16ILi128E" in fn and ("spill" in line
                                                 or "registers" in line):
                kind = re.search(r"attention_(\w+?)_bf16", fn).group(1)
                lines.append(f"{kind}: {line.strip()}")
        for fn, body in measure.sass_kernels(out).items():
            if "bf16ILi128E" in fn:
                kind = re.search(r"attention_(\w+?)_bf16", fn).group(1)
                lines.append("{}: HGMMA {} UTMALDG {} WARPGROUP.DEPBAR {}".format(
                    kind, *measure.sass_counts(body)))
        lib = ctypes.CDLL(out)
        for entry in at.ENTRIES:
            _cuda.declare(getattr(lib, entry), at.ATTENTION_ARGTYPES)
        libs[name] = (lib, lines)
    return libs


def main():
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_info()
    print(card)
    libs = build(VARIANTS, ABLATIONS)
    b, h, s, d = SHAPE
    q, k, v, do = measure.attention_inputs(dev, b, h, s, s, d,
                                           torch.bfloat16, True)
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    tiny = torch.empty(1, dtype=torch.uint8, device=dev)
    sc = 1.0 / math.sqrt(d)
    terms = at.abs_terms(q, k, v, do, True)
    ops = {n: o for n, (o, _) in measure.attention_bounds(b, h, s, s, d,
                                                     True).items()}
    rows = {}
    for name, (lib, lines) in libs.items():
        o, st = (torch.empty(q.shape, dtype=q.dtype, device=dev),
                 torch.empty(q.shape[:3] + (2,), device=dev))
        at._launch("dl4j_attention_fwd", q, k, v, sc, True, out=o, stats=st,
                   lib=lib)
        delta = at.bwd_delta_plain(o, do)
        dk, dv, dq = (torch.empty(t.shape, dtype=t.dtype, device=dev)
                      for t in (k, v, q))
        com = dict(o=o, dout=do, stats=st, delta=delta, lib=lib)
        runs = {
            "attention_fwd": lambda: at._launch(
                "dl4j_attention_fwd", q, k, v, sc, True,
                out=torch.empty_like(o), stats=torch.empty_like(st), lib=lib),
            "attention_bwd_delta": lambda: at._launch(
                "dl4j_attention_bwd_delta", q, k, v, sc, True, o=o, dout=do,
                stats=st, delta=torch.empty_like(delta), lib=lib),
            "attention_bwd_dkdv": lambda: at._launch(
                "dl4j_attention_bwd_dkdv", q, k, v, sc, True, dk=dk, dv=dv,
                **com),
            "attention_bwd_dq": lambda: at._launch(
                "dl4j_attention_bwd_dq", q, k, v, sc, True, dq=dq, **com)}
        for fn in runs.values():
            fn()
        torch.cuda.synchronize()
        po, _ = at.attention_fwd_plain(q, k, v, True)
        pdk, pdv = at.bwd_dkdv_plain(q, k, v, do, st, delta, True)
        pdq = at.bwd_dq_plain(q, k, v, do, st, delta, True)
        worst = max(float(((x.double() - p.double()).abs() / (
            2.0 ** -6 * t).clamp_min(1e-300)).max()) for x, p, t in (
            (o, po, terms[0]), (dq, pdq, terms[1]), (dk, pdk, terms[2]),
            (dv, pdv, terms[3])))
        rows[name] = ({n: measure.median_ms(fn, flush)
                       for n, fn in runs.items()}, worst, lines)
        if name == "kept":
            rows["kept, L2 warm"] = ({n: measure.median_ms(fn, tiny)
                                      for n, fn in runs.items()}, worst, [])
    import torch.nn.functional as F
    lq, lk, lv = (t.detach().requires_grad_(True) for t in (q, k, v))
    lib_fwd = measure.median_ms(lambda: F.scaled_dot_product_attention(
        lq, lk, lv, is_causal=True), flush)
    lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True)
    lib_bwd = measure.median_ms(lambda: torch.autograd.grad(
        lo, (lq, lk, lv), do, retain_graph=True), flush)
    print(f"\nper call at ({b}, {h}, {s}, {d}) bf16 causal, split views; "
          f"median of 20, ms (TFLOP/s); library forward {lib_fwd:.4f}, "
          f"backward {lib_bwd:.4f}  [{card}]")
    print(f"{'variant':22s} | " + " | ".join(f"{n:24s}" for n in KERNELS)
          + " | fwd/lib | bwd/lib | of tol")
    for name, (ms, worst, lines) in rows.items():
        print(f"{name:22s} | " + " | ".join(
            f"{ms[n]:.4f} ({ops[n] / ms[n] / 1e9:5.1f})".ljust(24)
            for n in KERNELS) + f" | {ms['attention_fwd'] / lib_fwd:7.3f} | "
            f"{sum(ms[n] for n in KERNELS[1:]) / lib_bwd:7.3f}"
            f" | {worst:.3f}")
        for line in lines:
            print(f"    {line}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
