"""A first check of the recurrence engine and the noise kernel on the card:
build ``csrc/lstm_recurrence.cu`` (the LSTM, GRU, Graves and simple RNN
kernels) and ``csrc/dropout.cu``, print ptxas's registers and spills,
hold each cell's kernels to their plain versions at a few widths (5-512
units, float32 and float64) with the plan each took, the noise kernel's
float32 normals to ``normals_plain`` (``NORMAL_KERNEL_REL``) and each
noise kind to its plain version, and time one call of each recurrence at
its path's shape (GRU and Graves (64, 256, 256), simple RNN and LSTM (32,
50, 256), float32) with CUDA events.

    python3 experiments/rnn_recurrence_first_check.py
"""
import sys, time
sys.path.insert(0, ".")
import torch
from deeplearning4j_tpu_torch.kernels import _cuda, lstm, recurrence
from deeplearning4j_tpu_torch.kernels import dropout as dk
from deeplearning4j_tpu_torch.kernels.measure import (
    lstm_recurrence_case, rnn_bwd_args, rnn_fwd_args, rnn_recurrence_case)

t0 = time.perf_counter()
recurrence._lib(); dk._lib()
print("built in", time.perf_counter() - t0, flush=True)
for lib in ("lstm_recurrence", "dropout"):
    for line in _cuda.build_log(lib).splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower() \
                or "Function properties" in line or "Compiling entry" in line:
            print(" ", lib, line.strip()[:160])
dev = torch.device("cuda")
print(torch.cuda.get_device_name(0), flush=True)
worst = 0.0
for cell in ("gru", "graves", "simple"):
    for dt in (torch.float32, torch.float64):
        for b, t, u in ((3, 4, 5), (5, 3, 24), (64, 50, 256), (7, 20, 100),
                        (7, 20, 384), (8, 10, 512)):
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
            again = recurrence.recurrence_bwd(cell, *rnn_bwd_args(case))
            same = all(x is None or torch.equal(x, y) for x, y in zip(again, got_b))
            p = recurrence._card_plan(0, cell, dt, b, u)
            tol = 1e-5 if dt == torch.float32 else 1e-12
            worst = max(worst, max(errs) / tol)
            print(cell, str(dt)[6:], (b, t, u), "R", p.ranks, "tiles", p.n_tiles,
                  "res", p.resident, "card holds", p.max_clusters, "errs",
                  ["%.1e" % e for e in errs], "twice bit-equal", same,
                  "OK" if max(errs) <= tol and same else "FAIL", flush=True)
print("worst error over its tolerance", worst, flush=True)
for dt in (torch.float32, torch.float64):
    for b, t, u in ((32, 50, 256), (3, 7, 37), (8, 20, 512)):
        gx, w, h0, c0, d_hs, dh_t, dc_t = lstm_recurrence_case(b, t, u, dt, dev)
        want_f = lstm.lstm_recurrence_fwd_plain(gx, w, h0, c0)
        got_f = lstm.lstm_recurrence_fwd(gx.clone(), w, h0, c0)
        bwd_in = (want_f[0], want_f[2], c0, w, d_hs, dh_t, dc_t)
        want_b = lstm.lstm_recurrence_bwd_plain(*bwd_in)
        got_b = lstm.lstm_recurrence_bwd(*bwd_in)
        torch.cuda.synchronize()
        errs = [float((g - x).abs().max()) / float(x.abs().max())
                for g, x in zip(got_f + got_b, want_f + want_b)]
        print("lstm", str(dt)[6:], (b, t, u), "errs", ["%.1e" % e for e in errs],
              flush=True)


def events_ms(fn, n=5):
    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(n):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / n


for cell, (b, t, u) in (("gru", (64, 256, 256)), ("graves", (64, 256, 256)),
                        ("simple", (32, 50, 256))):
    case = rnn_recurrence_case(cell, b, t, u, torch.float32, dev)
    buf = case["gx"].clone()
    f = events_ms(lambda: recurrence.recurrence_fwd(cell, buf, *rnn_fwd_args(case)))
    bw = events_ms(lambda: recurrence.recurrence_bwd(cell, *rnn_bwd_args(case)))
    print(cell, (b, t, u), "fwd ms/call %.4f (%.3f us a step), bwd %.4f (%.3f)"
          % (f, 1e3 * f / t, bw, 1e3 * bw / t), flush=True)
gx, w, h0, c0, d_hs, dh_t, dc_t = lstm_recurrence_case(32, 50, 256, torch.float32, dev)
buf = gx.clone()
gates, hs, cs = lstm.lstm_recurrence_fwd(buf, w, h0, c0)
f = events_ms(lambda: lstm.lstm_recurrence_fwd(buf, w, h0, c0))
bw = events_ms(lambda: lstm.lstm_recurrence_bwd(gates, cs, c0, w, d_hs, dh_t, dc_t))
print("lstm (32, 50, 256) fwd ms/call %.4f, bwd %.4f" % (f, bw), flush=True)
seed = torch.tensor([5], dtype=torch.int64, device=dev)
it = torch.tensor([2], dtype=torch.int64, device=dev)
x0 = torch.zeros(64, 256, 300, device=dev)
nk = dk.noise_apply("gaussian_noise", x0, seed, it, 3, "gaussian_noise_fwd", stddev=1.0)
npl = dk.normals_plain(x0.numel(), seed, it, 3, dev, torch.float32).reshape(x0.shape)
rel = float(((nk.double() - npl.double()).abs() / npl.double().abs().clamp_min(1e-30)).max())
print("float32 normals: kernel vs plain max relative %.3e (bound %.3e)"
      % (rel, dk.NORMAL_KERNEL_REL), flush=True)
for kind in ("gaussian_noise", "gaussian_dropout", "alpha_dropout",
             "alpha_dropout_bwd", "spatial_dropout"):
    for dt in (torch.float32, torch.float64, torch.bfloat16):
        x = torch.randn(64, 50, 77, device=dev).to(dt)
        got = dk.noise_apply(kind, x, seed, it, 3, "gaussian_noise_fwd", p=0.9, stddev=0.3)
        want = dk.noise_plain(kind, x, seed, it, 3, p=0.9, stddev=0.3)
        print(kind, dt, "max diff", float((got.double() - want.double()).abs().max()),
              "equal", torch.equal(got, want), flush=True)
xg = torch.randn(64, 256, 300, device=dev)
print("gaussian_noise (64, 256, 300) ms/call %.5f, torch.normal %.5f" % (
    events_ms(lambda: dk.noise_apply("gaussian_noise", xg, seed, it, 3,
                                     "gaussian_noise_fwd", stddev=0.1), 20),
    events_ms(lambda: torch.normal(xg, 0.1), 20)), flush=True)
