"""The GRU, Graves and simple RNN recurrence kernels against their plain
versions (``chip_smoke.py`` phase 29 gate (i)), then each alone at the
paths' shapes and one streamed width (``median_ms``: L2 cold, queued
behind a device sleep).

    python3 experiments/rnn_recurrence_times.py
"""
import sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from deeplearning4j_tpu_torch.kernels import recurrence
from deeplearning4j_tpu_torch.kernels.measure import (
    median_ms, rnn_bwd_args, rnn_fwd_args, rnn_recurrence_case)
t0 = time.perf_counter()
recurrence._lib()
print("built", time.perf_counter() - t0, flush=True)
dev = torch.device("cuda")
cs.p29_check_kernels(dev)
flush = torch.empty(2 ** 28, dtype=torch.float32, device=dev)
for cell, (b, t, u) in (("gru", (64, 256, 256)), ("graves", (64, 256, 256)),
                        ("simple", (32, 50, 256)), ("gru", (64, 50, 512))):
    case = rnn_recurrence_case(cell, b, t, u, torch.float32, dev)
    buf = case["gx"].clone()
    f = median_ms(lambda: recurrence.recurrence_fwd(cell, buf, *rnn_fwd_args(case)), flush)
    bw = median_ms(lambda: recurrence.recurrence_bwd(cell, *rnn_bwd_args(case)), flush)
    print(f"{cell} ({b}, {t}, {u}): fwd {f:.5f} ms ({1e3 * f / t:.3f} us a step), "
          f"bwd {bw:.5f} ms ({1e3 * bw / t:.3f} us a step)", flush=True)
