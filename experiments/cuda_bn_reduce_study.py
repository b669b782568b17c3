"""Where the time of the BN backward's phase-1 CUDA kernel goes, on the card.

    python3 experiments/cuda_bn_reduce_study.py

At the ResNet-50 path's nine bf16 BN shapes (batch 128, 224x224), each
call timed by CUDA events after the L2 cache was filled with other data:

1. the timing floor: a one-element fill, and the kernel and
   ``batch_norm_backward_reduce``, each after a 1 GiB write (what
   ``chip_smoke.py`` does: it leaves ~50 MB of dirty lines in L2 for the
   next kernel to write back) and after a 1 GiB read (clean lines);
2. ablations of ``deeplearning4j_tpu_torch/csrc/bn_bwd_reduce.cu``,
   built from text edits of the source (timing only; their results are
   wrong by design): without the main loop, returning before the
   workspace stores, before the count, before the last block's work, and
   without the split sums;
3. the grid: 1, 2 (the wrapper's rule), 3 and 4 blocks per SM, where any
   count above two per SM runs as more than one wave.

Prints one table per part, with the card's name and power limit. Builds
its variants under ``deeplearning4j_tpu_torch/_build/study/``. Imports
nothing of JAX.
"""
import ctypes
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from deeplearning4j_tpu_torch.environment import card_info  # noqa: E402
from deeplearning4j_tpu_torch.kernels import _cuda, bn_relu  # noqa: E402

BW = 3.35e12
SHAPES = [((128, 64, 112, 112), True, 1), ((128, 64, 55, 55), True, 6),
          ((128, 128, 28, 28), True, 8), ((128, 256, 14, 14), True, 12),
          ((128, 512, 7, 7), True, 6), ((128, 256, 55, 55), False, 4),
          ((128, 512, 28, 28), False, 5), ((128, 1024, 14, 14), False, 7),
          ((128, 2048, 7, 7), False, 4)]
ABLATIONS = {
    "full": [],
    "no main loop": [("  if (p.vec) {", "  if (p.vec && false) {"),
                     ("for (int64_t r = r_begin + ty; r < r_end; r += TY)",
                      "for (int64_t r = r_end; r < r_end; r += TY)")],
    "no ws stores": [("  Acc* ws = static_cast<Acc*>(p.ws);",
                      "  if (p.R > 0) return;\n"
                      "  Acc* ws = static_cast<Acc*>(p.ws);")],
    "no count": [("  // publish, then count this block in;",
                  "  if (p.R > 0) return;\n"
                  "  // publish, then count this block in;")],
    "no last block": [("  if (!is_last) return;", "  if (p.R > 0) return;")],
    "no split sums": [("for (int s = sl; s < splits;",
                       "for (int s = splits; s < splits;")],
}


def build(variants):
    """Build each variant's library in parallel; returns name -> CDLL."""
    src = open(_cuda.source("bn_bwd_reduce")).read()
    procs = {}
    for name, edits in variants.items():
        text = src
        for old, new in edits:
            assert old in text, old
            text = text.replace(old, new)
        d = os.path.join(_cuda.PACKAGE, "_build", "study",
                         name.replace(" ", "_"))
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "bn_bwd_reduce.cu"), "w") as f:
            f.write(text)
        out = os.path.join(d, "lib.so")
        procs[name] = (subprocess.Popen(
            _cuda.build_command("bn_bwd_reduce", out, _cuda.nvcc(), csrc=d),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        libs[name] = ctypes.CDLL(out)
        for relu in (True, False):
            _cuda.declare(getattr(libs[name],
                                  f"dl4j_{bn_relu.kernel_name(1, relu)}"),
                          bn_relu.PHASE1_ARGTYPES)
    return libs


def timed_us(fn, before, iters=20):
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for s, e in ev:
        before()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return 1e3 * sum(s.elapsed_time(e) for s, e in ev) / iters


def inputs(shape, relu, dev):
    n, c, h, w = shape
    g = torch.Generator(device=dev).manual_seed(0)
    x = (torch.randn(shape, device=dev, generator=g)
         + 2 * torch.randn(1, c, 1, 1, device=dev, generator=g))
    x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    dy = torch.randn(shape, device=dev, generator=g).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    gamma = (1 + 0.1 * torch.randn(c, device=dev, generator=g)).to(
        torch.bfloat16)
    beta = (0.1 * torch.randn(c, device=dev, generator=g)).to(torch.bfloat16)
    _, mean, _, inv, a, b = bn_relu.bn_train_forward(x, gamma, beta, 1e-5,
                                                     relu)
    return x, dy, gamma, mean, inv, a, b


def table(title, cols, rows):
    print(f"\n{title}\n{'shape':22s} relu  n  bound | " + " | ".join(cols))
    tot = [0.0] * len(cols)
    for (shape, relu, n), bound, vals in rows:
        print(f"{str(shape):22s} {int(relu):4d} {n:2d} {bound:6.1f} | "
              + " | ".join(f"{v:{len(c)}.1f}" for c, v in zip(cols, vals)))
        tot = [t + n * v for t, v in zip(tot, vals)]
    print(f"{'per step (us)':36s} | " + " | ".join(
        f"{t:{len(c)}.0f}" for c, t in zip(cols, tot)))


def main():
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(card_info())
    big = torch.empty(2**30, dtype=torch.uint8, device=dev).fill_(1)
    write_flush, read_flush = big.zero_, lambda: big.view(torch.int64).sum()
    ws = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    libs = build(ABLATIONS)
    tiny = torch.empty(1, device=dev)
    print(f"\none-element fill: {timed_us(tiny.zero_, write_flush):.1f} us "
          f"after a 1 GiB write, {timed_us(tiny.zero_, read_flush):.1f} us "
          f"after a 1 GiB read")
    flush_rows, abl_rows, grid_rows = [], [], []
    for shape, relu, n in SHAPES:
        x, dy, gamma, mean, inv, a, b = inputs(shape, relu, dev)
        bound = 1e6 * 2 * x.numel() * x.element_size() / BW
        wf = gamma.float()

        def call(name, cps=bn_relu._CTAS_PER_SM):
            fn = getattr(libs[name], f"dl4j_{bn_relu.kernel_name(1, relu)}")
            cnt = torch.zeros(1 << 16, dtype=torch.int32, device=dev)
            return lambda: bn_relu._launch_phase1(
                fn, x, dy, a, b, mean, inv, gamma, relu, sms * cps // 2,
                lambda nb, nc: (ws, cnt), stream)

        def lib():
            torch.ops.aten.batch_norm_backward_reduce(dy, x, mean, inv, wf,
                                                      True, True, True)

        flush_rows.append(((shape, relu, n), bound, [
            timed_us(call("full"), write_flush),
            timed_us(call("full"), read_flush),
            timed_us(lib, write_flush), timed_us(lib, read_flush)]))
        abl_rows.append(((shape, relu, n), bound, [
            timed_us(call(k), read_flush) for k in ABLATIONS]))
        # blocks per SM: the plan is asked for sms * cps // 2 SMs' worth
        grid_rows.append(((shape, relu, n), bound, [
            timed_us(call("full", cps), read_flush) for cps in (1, 2, 3, 4)]))
        del x, dy
    table("1. timing floor (us per call)", ["kernel, write", "kernel, read",
                                           "library, write",
                                           "library, read"], flush_rows)
    table("2. ablations (us per call, after a 1 GiB read)", list(ABLATIONS),
          abl_rows)
    table("3. blocks per SM (us per call, after a 1 GiB read)",
          ["1/SM", "2/SM", "3/SM", "4/SM"], grid_rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
