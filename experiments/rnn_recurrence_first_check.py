"""A first check of the GRU, Graves and simple RNN recurrence kernels and
the noise kernel on the card: build ``csrc/rnn_recurrence.cu`` and
``csrc/dropout.cu``, print ptxas's registers and spills, hold each cell's
kernels to their plain versions at a few widths (3-512 units, float32 and
float64) and each noise kind to its plain version, and time one call of
each recurrence at (64, 256, 256) float32 with CUDA events.

    python3 experiments/rnn_recurrence_first_check.py
"""
import sys, time
sys.path.insert(0, ".")
import torch
from deeplearning4j_tpu_torch.kernels import _cuda, recurrence
from deeplearning4j_tpu_torch.kernels import dropout as dk
from deeplearning4j_tpu_torch.kernels.measure import (
    rnn_bwd_args, rnn_fwd_args, rnn_recurrence_case)

t0 = time.perf_counter()
recurrence._lib(); dk._lib()
print("built in", time.perf_counter() - t0, flush=True)
for lib in ("rnn_recurrence", "dropout"):
    for line in _cuda.build_log(lib).splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            print(" ", lib, line.strip())
dev = torch.device("cuda")
for cell in ("gru", "graves", "simple"):
    for dt in (torch.float32, torch.float64):
        for b, t, u in ((3, 4, 5), (64, 50, 256), (7, 20, 384), (8, 10, 512)):
            case = rnn_recurrence_case(cell, b, t, u, dt, dev, seed=1)
            got_f = recurrence.recurrence_fwd(cell, case["gx"].clone(),
                                              *rnn_fwd_args(case))
            want_b = recurrence.recurrence_bwd_plain(cell, *rnn_bwd_args(case))
            got_b = recurrence.recurrence_bwd(cell, *rnn_bwd_args(case))
            torch.cuda.synchronize()
            errs = []
            for g, w in list(zip(got_f, (case["saved"], case["hs"], case["cs"],
                                         case["hn"]))) + list(zip(got_b, want_b)):
                if w is None:
                    continue
                errs.append(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30))
            p = recurrence._card_plan(0, cell, dt, b, u)
            print(cell, dt, (b, t, u), "R", p.ranks, "res", p.resident,
                  "errs", ["%.1e" % e for e in errs], flush=True)
# rough step time at the path's shape
for cell in ("gru", "graves", "simple"):
    case = rnn_recurrence_case(cell, 64, 256, 256, torch.float32, dev)
    buf = case["gx"].clone()
    for name, fn in (("fwd", lambda: recurrence.recurrence_fwd(cell, buf, *rnn_fwd_args(case))),
                     ("bwd", lambda: recurrence.recurrence_bwd(cell, *rnn_bwd_args(case)))):
        fn(); torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(5):
            fn()
        e.record(); torch.cuda.synchronize()
        print(cell, name, "ms/call", s.elapsed_time(e) / 5, flush=True)
seed = torch.tensor([5], dtype=torch.int64, device=dev)
it = torch.tensor([2], dtype=torch.int64, device=dev)
for kind in ("gaussian_noise", "gaussian_dropout", "alpha_dropout",
             "alpha_dropout_bwd", "spatial_dropout"):
    for dt in (torch.float32, torch.float64, torch.bfloat16):
        x = torch.randn(64, 50, 77, device=dev).to(dt)
        got = dk.noise_apply(kind, x, seed, it, 3, "gaussian_noise_fwd", p=0.9, stddev=0.3)
        want = dk.noise_plain(kind, x, seed, it, 3, p=0.9, stddev=0.3)
        print(kind, dt, "max diff", float((got.double() - want.double()).abs().max()),
              "equal", torch.equal(got, want), flush=True)
