"""Drive the PyTorch/CUDA port on one NVIDIA card, and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. env: torch, CUDA, nvcc and Triton versions; the card's name and power
   limit; the build of the CUDA C++ kernels (seconds, and ptxas's
   registers per kernel).
2. kernels: the BN(+ReLU) backward's kernels against their plain PyTorch
   versions on the card (bf16 and f32, ReLU on and off; the TPU spike's
   three shapes, ResNet-50's stem, a ragged shape, and a dy that arrives
   in NCHW layout): phase 1 (CUDA C++, with its fold: five outputs, two
   calls bit-equal) and phase 2 (Triton).
3. parity: ResNet-50 at 32x32, 4 classes, TF32 off: two ``fit`` steps on
   the card (kernels) and on the CPU (plain versions) from the same
   weights, in float64 (every tensor's change, every running statistic
   and both losses, card against CPU) and in float32 (held to the
   float64 step).
4. main path: ResNet-50 at 224x224, 1000 classes, batch 128, bf16
   MixedPrecision, through ``ResNet50(...).conf()`` ->
   ``ComputationGraph(conf).init()`` -> ``net.fit(DeviceCachedIterator)``:
   one warm-up epoch, then a timed epoch of STEPS steps in which every
   kernel of the path must launch (33 + 20 BN layers, two phases each),
   then two steps under ``torch.profiler`` for where the device time goes
   and how many device launches a step makes.
5. path shapes: at each shape, dtype, ReLU flag and dy layout the main
   path gave the kernels, each kernel against its plain version, then
   timed with its plain version and, where one PyTorch call computes the
   same function, that call, summed over one training step, beside the
   least time the card could take (bytes over the card's memory rate).

The last lines are the kernels' JSON record (``launches`` counts the
timed epoch of STEPS steps, ``launches_per_step`` one step; the times
are per training step), the card's name and power limit, and
``{"ok": true, "device": {...}}``. Nothing of JAX or of the
JAX package is imported.
"""
import json
import sys
import time

import numpy as np
import torch

STEPS = 8
BATCH = 128
# (memory bytes/s, non-tensor-core f32 FLOP/s) from NVIDIA's data sheets
CARDS = {"PCIe": (2.0e12, 51e12), "NVL": (3.9e12, 60e12),
         "H100": (3.35e12, 67e12)}
REPLACES = {1: "experiments/pallas_bn_spike.py:87",
            2: "experiments/pallas_bn_spike.py:115"}
ROUTE = {1: ("cuda", "deeplearning4j_tpu_torch/csrc/bn_bwd_reduce.cu"),
         2: ("triton", "deeplearning4j_tpu_torch/kernels/bn_relu_triton.py")}
#: device launches per training step measured on an H100 when phase 1 was
#: a Triton kernel followed by its fold in PyTorch ops (PERF.md)
TRITON_PHASE1_LAUNCHES_PER_STEP = 4895


def log(*a):
    print(*a, flush=True)


def card_rates(name):
    for key in ("PCIe", "NVL", "H100"):
        if key in name:
            return CARDS[key]
    raise SystemExit(f"no memory/compute rates on record for {name!r}")


# ----------------------------------------------------------------------
def rel_err(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def bn_inputs(shape, dtype, relu, dev, nchw_dy=False, seed=0,
              gdtype=torch.float32):
    """x channels-last with a per-channel offset, dy, and the forward's
    statistics, on the card; gamma in ``gdtype``. ``shape`` is
    (N, H, W, C)."""
    from deeplearning4j_tpu_torch.kernels import bn_relu
    n, h, w, c = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(n, c, h, w, device=dev, generator=g)
         + 2 * torch.randn(1, c, 1, 1, device=dev, generator=g))
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    dy = torch.randn(n, c, h, w, device=dev, generator=g).to(dtype)
    if not nchw_dy:
        dy = dy.contiguous(memory_format=torch.channels_last)
    gamma = (1 + 0.1 * torch.randn(c, device=dev, generator=g)).to(gdtype)
    beta = (0.1 * torch.randn(c, device=dev, generator=g)).to(gdtype)
    _, mean, _, inv, a, b = bn_relu.bn_train_forward(x, gamma, beta, 1e-5,
                                                     relu)
    return x, dy, gamma, mean, inv, a, b


def check_kernels(x, dy, gamma, mean, inv, a, b, relu, errs, label):
    """Both kernels against their plain versions on the same inputs.
    Phase 1's sum-derived outputs are held per channel to 1e-5 of the sum
    of the absolute terms behind them (a float32 sum over R terms in
    another order errs by at most ~log2(R) * 6e-8 of that), plus, for
    dgamma and dbeta in a bf16 gamma's dtype, one unit in its last place
    (one rounding to 8 bits); g = gamma * inv to one unit in its last
    place; two calls must be bit-equal. Phase 2's dx is
    held to 1e-5 (f32) or 8e-3 (bf16: one rounding to 8 bits) of max
    |dx|. Exits on a mismatch."""
    from deeplearning4j_tpu_torch.kernels import bn_relu
    got = bn_relu.bn_bwd_phase1(x, dy, a, b, mean, inv, gamma, relu)
    again = bn_relu.bn_bwd_phase1(x, dy, a, b, mean, inv, gamma, relu)
    want = bn_relu.phase1_fold_plain(x, dy, a, b, mean, inv, gamma, relu)
    same = all(torch.equal(p, q) for p, q in zip(got, again))
    dz = bn_relu._masked_dy(x, dy, a, b, relu)
    red = bn_relu._red(x)
    t1 = dz.abs().sum(red).double()
    t2 = (dz * (bn_relu._up(x) - bn_relu._chan(mean, x))).abs().sum(
        red).double()
    del dz
    r, iv = x.numel() // x.shape[1], inv.double()
    e1, abs1 = 0.0, 0.0
    for k, w, terms in zip(got, want, (iv * t2, t1, None, t1 / r,
                                       iv * iv * t2 / r)):
        err = (k.double() - w.double()).abs()
        ulp = torch.finfo(w.dtype).eps * w.double().abs()
        tol = ulp if terms is None else 1e-5 * terms + (
            ulp if w.dtype != mean.dtype else 0.0)
        e1 = max(e1, float((err / tol.clamp_min(1e-300)).max()))
        abs1 = max(abs1, float(err.max()))
    _, _, g, c1, c2 = want
    dx = bn_relu.bn_bwd_phase2(x, dy, a, b, mean, g, c1, c2, relu)
    px = bn_relu.phase2_plain(x, dy, a, b, mean, g, c1, c2, relu)
    torch.cuda.synchronize()
    assert dx.stride() == x.stride(), (dx.stride(), x.stride())
    e2 = rel_err(dx, px)
    tol2 = 1e-5 if x.dtype == torch.float32 else 8e-3
    k1, k2 = bn_relu.kernel_name(1, relu), bn_relu.kernel_name(2, relu)
    errs[k1] = max(errs.get(k1, 0.0), abs1)
    errs[k2] = max(errs.get(k2, 0.0),
                   float((dx.float() - px.float()).abs().max()))
    ok = e1 <= 1 and same and e2 <= tol2
    log(f"  {label}: phase1 {e1:.2e} of its tolerance, bit-equal twice "
        f"{same}  phase2 {e2:.2e} (tol {tol2:g})  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("kernel disagrees with its plain version")


def phase_kernels(dev, errs):
    """The kernels against their plain versions at the TPU spike's three
    shapes, ResNet-50's stem, a ragged shape and a dy in NCHW layout."""
    shapes = [((128, 56, 56, 256), False), ((128, 28, 28, 512), False),
              ((128, 56, 56, 64), False), ((128, 112, 112, 64), False),
              ((3, 7, 9, 100), False), ((32, 28, 28, 128), True)]
    for dtype in (torch.bfloat16, torch.float32):
        for relu in (True, False):
            for shape, nchw_dy in shapes:
                x, dy, gamma, mean, inv, a, b = bn_inputs(
                    shape, dtype, relu, dev, nchw_dy)
                check_kernels(x, dy, gamma, mean, inv, a, b, relu, errs,
                              f"{str(dtype)[6:]:8s} relu={int(relu)} "
                              f"{shape} dy={'NCHW' if nchw_dy else 'NHWC'}")
                del x, dy
    torch.cuda.empty_cache()


# ----------------------------------------------------------------------
def _max_rel(a, b):
    return {k: float(np.max(np.abs(a[k].astype(np.float64) - b[k])))
            / max(float(np.max(np.abs(b[k]))), 1e-30) for k in b}


def phase_parity():
    """Two fit steps of ResNet-50 at 32x32, 4 classes, batch 8, from the
    same weights, on the card (kernels) and on the CPU (plain versions),
    TF32 off.

    float64: every trained tensor's change over each step, every
    running statistic and both steps' losses, card against CPU, to 1e-6
    of the CPU value's magnitude. Readings the bound sits between (see
    PERF.md): the CPU float32 step's own distance from the float64 step
    (0.11 of a tensor's change on the worst tensor, 1.3e-2 on the median
    one, printed in the run), and the card's float64 distance from the
    CPU's (5e-10 on the worst tensor on an H100).

    float32 (the dtype the issue names, and cuDNN's float32 convolutions):
    this network's float32 step is ill-conditioned at this size (the
    CPU float32 step itself lands up to ~20% of a parameter's magnitude
    from the float64 step), so the card's step is held to the float64
    step no farther than 3x the CPU float32 step is, over the worst and
    the median tensor, and its first loss to 1e-3."""
    from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
    from deeplearning4j_tpu_torch.nn import ComputationGraph
    from deeplearning4j_tpu_torch.zoo import ResNet50
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("  TF32 off: torch.backends.cudnn.allow_tf32 = False, "
        "torch.backends.cuda.matmul.allow_tf32 = False")
    rng = np.random.default_rng(0)
    b = 8
    x = rng.normal(size=(2 * b, 3, 32, 32))
    y = np.eye(4)[rng.integers(0, 4, 2 * b)]
    weights = ResNet50(height=32, width=32, num_classes=4).build(
        device="cpu").model.state_dict()
    res = {}
    for tag, dev, dt in (("card32", "cuda", "float32"),
                         ("cpu32", "cpu", "float32"),
                         ("card64", "cuda", "float64"),
                         ("cpu64", "cpu", "float64")):
        conf = ResNet50(height=32, width=32, num_classes=4).conf()
        conf.dtype = dt
        net = ComputationGraph(conf).init(device=dev)
        net.model.load_state_dict(weights)
        steps = [net.params()]
        losses = []
        for s in range(2):
            losses.append(net.fit(DeviceCachedIterator(
                x[s * b:(s + 1) * b].astype(dt),
                y[s * b:(s + 1) * b].astype(dt), batch_size=b, device=dev)
            ).final_loss())
            steps.append(net.params())
        res[tag] = (losses, steps)
    torch.backends.cudnn.allow_tf32 = True
    p64 = res["cpu64"][1]
    stats = [k for k in p64[0] if k.endswith(("_mean", "_var"))]
    # conv biases feed a batch norm: their true gradient is 0, and what
    # either side holds there is rounding noise
    trained = [k for k in p64[0] if k not in stats
               and not (k.endswith("_b") and k != "output_b")]

    # float64, card against CPU, per tensor
    (lc, pc), (lh, ph) = res["card64"], res["cpu64"]
    worst, where = 0.0, ""
    for s in (1, 2):
        dc = {k: pc[s][k] - pc[s - 1][k] for k in trained}
        dh = {k: ph[s][k] - ph[s - 1][k] for k in trained}
        for kind, errs in (("change", _max_rel(dc, dh)),
                           ("statistic", _max_rel(
                               {k: pc[s][k] for k in stats},
                               {k: ph[s][k] for k in stats}))):
            k = max(errs, key=errs.get)
            if errs[k] > worst:
                worst, where = errs[k], f"step {s} {kind} {k}"
    loss64 = max(abs(c - h) / abs(h) for c, h in zip(lc, lh))
    p32 = res["cpu32"][1]
    d32 = _max_rel({k: p32[1][k] - p32[0][k] for k in trained},
                   {k: ph[1][k] - ph[0][k] for k in trained})
    log(f"  float64 losses card {lc} cpu {lh} (worst {loss64:.2e}, tol "
        f"1e-6); card vs cpu over {len(trained)} trained tensors' changes "
        f"and {len(stats)} statistics, both steps: worst {worst:.2e} "
        f"({where}), tol 1e-6; for scale, cpu float32 vs float64 step-1 "
        f"change: worst {max(d32.values()):.3e}, median "
        f"{float(np.median(list(d32.values()))):.3e}")
    ok64 = worst <= 1e-6 and loss64 <= 1e-6 and all(
        np.all(np.isfinite(v)) for v in pc[2].values())

    # float32, card and CPU each against the float64 step
    (lc, pc), (l32, p32) = res["card32"], res["cpu32"]
    ec, e32 = _max_rel(pc[1], ph[1]), _max_rel(p32[1], ph[1])
    worst = (max(ec[k] for k in trained), max(e32[k] for k in trained))
    med = (float(np.median([ec[k] for k in trained])),
           float(np.median([e32[k] for k in trained])))
    loss_err = abs(lc[0] - l32[0]) / abs(l32[0])
    log(f"  float32 loss card {lc[0]:.7f} cpu32 {l32[0]:.7f} cpu64 "
        f"{lh[0]:.7f} (card vs cpu32 {loss_err:.2e}, tol 1e-3)")
    log(f"  float32 params vs f64, worst tensor: card {worst[0]:.3e} cpu32 "
        f"{worst[1]:.3e}; median tensor: card {med[0]:.3e} cpu32 "
        f"{med[1]:.3e} (tol 3x cpu32)")
    ok32 = loss_err <= 1e-3 and worst[0] <= 3 * worst[1] + 1e-6 and \
        med[0] <= 3 * med[1] + 1e-7 and set(pc[1]) == set(ph[1]) and \
        all(np.all(np.isfinite(v)) for v in pc[1].values())
    if not (ok64 and ok32):
        raise SystemExit("card step disagrees with the CPU step")


# ----------------------------------------------------------------------
def phase_main(dev, card):
    """Returns (per-step record of the BN calls, launches, metrics)."""
    from deeplearning4j_tpu_torch.autodiff import MixedPrecision
    from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
    from deeplearning4j_tpu_torch.kernels import bn_relu
    from deeplearning4j_tpu_torch.nn import ComputationGraph
    from deeplearning4j_tpu_torch.zoo import ResNet50

    conf = ResNet50(height=224, width=224, channels=3,
                    num_classes=1000).conf()
    conf.mixed_precision = MixedPrecision()
    t0 = time.perf_counter()
    net = ComputationGraph(conf).init()
    rng = np.random.default_rng(0)
    n = BATCH * STEPS
    x = rng.standard_normal((n, 3, 224, 224), dtype=np.float32)
    y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, n)]
    it = DeviceCachedIterator(x, y, batch_size=BATCH)
    del x, y
    log(f"  built net ({net.num_params()} params) and uploaded {n} "
        f"images in {time.perf_counter() - t0:.1f} s")

    # the shapes and layouts the path hands the kernels (recorded, not
    # counted: the launch counts are the wrappers' own)
    calls = []
    real = bn_relu.bn_relu_bwd

    def recording(x, dy, gamma, mean, inv, a, b, relu):
        calls.append((tuple(x.shape), bool(relu), str(x.dtype)[6:],
                      dy.is_contiguous(memory_format=torch.channels_last),
                      str(gamma.dtype)[6:]))
        return real(x, dy, gamma, mean, inv, a, b, relu)

    bn_relu.bn_relu_bwd = recording
    try:
        t0 = time.perf_counter()
        warm = net.fit(it, epochs=1)
        torch.cuda.synchronize()
        log(f"  warm-up epoch ({STEPS} steps, kernel builds included): "
            f"{time.perf_counter() - t0:.1f} s, loss {warm.final_loss():.4f}")
        calls.clear()
        torch.cuda.reset_peak_memory_stats()
        bn_relu.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = net.fit(it, epochs=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(bn_relu.LAUNCHES)
    finally:
        bn_relu.bn_relu_bwd = real
    loss = hist.final_loss()
    peak = torch.cuda.max_memory_allocated()
    step_ms = 1000 * wall / STEPS
    log(f"  timed epoch: {STEPS} steps in {wall:.3f} s: step {step_ms:.2f} "
        f"ms, {BATCH * STEPS / wall:.1f} samples/s, mean loss {loss:.4f}, "
        f"peak memory {peak / 2**30:.2f} GiB  [{card}]")
    log(f"  launches {launches}")
    want = {bn_relu.kernel_name(p, r): (33 if r else 20) * STEPS
            for p in (1, 2) for r in (True, False)}
    if not np.isfinite(loss):
        raise SystemExit(f"non-finite loss {loss}")
    if launches != want or sum(launches.values()) != 106 * STEPS:
        raise SystemExit(f"launches {launches}, want {want}")
    per_step = calls[:len(calls) // STEPS]
    if len(calls) != 53 * STEPS or sorted(per_step) != sorted(
            calls[-len(per_step):]):
        raise SystemExit(f"{len(calls)} BN backward calls recorded")
    nchw = sum(not c[3] for c in per_step)
    log(f"  dy layout over one step's 53 BN backwards: {53 - nchw} "
        f"channels-last, {nchw} other")
    metrics = {"step_ms": step_ms, "samples_per_s": BATCH * STEPS / wall,
               "loss": loss, "peak_mem_gib": peak / 2**30}
    metrics["profile"] = profile_steps(net, it, step_ms, card)
    del net, it
    torch.cuda.empty_cache()
    return per_step, launches, metrics


KERNEL_KINDS = (
    ("BN backward (CUDA C++ + Triton)", ("bn_relu_bwd_phase",
                                         "bn_bwd_phase")),
    ("convolution / matmul", ("conv", "cudnn", "nvjet", "gemm", "xmma",
                              "cutlass", "sm90_", "wgrad", "dgrad")),
    ("pooling", ("pool",)),
    ("reductions", ("reduce_kernel",)),
    ("elementwise", ("elementwise", "Functor")),
)


def profile_steps(net, it, step_ms, card):
    """Two steps under torch.profiler: device time per step by kernel and
    by kind, against the unprofiled step time (the rest is the device's
    idle share)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    batches = iter(it)
    two = [next(batches), next(batches)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        net.fit(two, epochs=1)
        torch.cuda.synchronize()
    per_kernel, by_kind = {}, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0)) / 2e3
        per_kernel[e.key] = (ms, e.count // 2)
        kind = next((k for k, keys in KERNEL_KINDS
                     if any(t in e.key for t in keys)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
    busy = sum(ms for ms, _ in per_kernel.values())
    if busy == 0:
        raise SystemExit("the profiler recorded no device time")
    launches = sum(n for _, n in per_kernel.values())
    log(f"  profiler, per step: device busy {busy:.2f} ms of an unprofiled "
        f"{step_ms:.2f} ms step: idle share {1 - busy / step_ms:.3f}; "
        f"{launches} device launches ({TRITON_PHASE1_LAUNCHES_PER_STEP} "
        f"with the Triton phase 1 and its PyTorch fold)  "
        f"[{card}]")
    for kind, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        log(f"    {ms:8.3f} ms  {ms / step_ms:.3f} of the step  {kind}")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:12]
    for key, (ms, n) in top:
        log(f"    {ms:8.3f} ms  x{n:<4d} {key[:96]}")
    # the BN backward's kernels by name (phase 1's CUDA kernels carry a
    # dtype suffix: bn_relu_bwd_phase1_bf16)
    from deeplearning4j_tpu_torch.kernels import bn_relu
    kernel_ms, kernel_n = {}, {}
    for key, (ms, n) in per_kernel.items():
        for name in bn_relu.LAUNCHES:
            if key == name or key.startswith(name + "_"):
                kernel_ms[name] = kernel_ms.get(name, 0.0) + ms
                kernel_n[name] = kernel_n.get(name, 0) + n
    log(f"    BN backward device launches per step: {kernel_n}")
    want = {bn_relu.kernel_name(p, r): 33 if r else 20
            for p in (1, 2) for r in (True, False)}
    if kernel_n != want:
        raise SystemExit(f"profiled BN backward launches {kernel_n}, "
                         f"want {want}")
    return {"busy_ms": busy, "idle_share": 1 - busy / step_ms,
            "launches": launches, "by_kind_ms": by_kind,
            "kernel_ms": kernel_ms,
            "top": [(k[:96], v[0], v[1]) for k, v in top]}


# ----------------------------------------------------------------------
def time_ms(fn, flush, iters):
    """Mean device time of ``fn`` over ``iters`` launches, each after the
    L2 cache was overwritten (the main path finds these inputs cold). The
    overwrite (1 GiB, ~0.3 ms) keeps the card busy while the host queues
    ``fn``, so the host's launch time stays outside the events."""
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for s, e in ev:
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in ev) / iters


def phase_timing(dev, per_step, card_name, errs):
    """At each (shape, ReLU, dtype, dy layout, gamma dtype) the main path
    gave the kernels: both kernels held to their plain versions, then, per
    training step, each kernel, its plain version and its library call
    timed over the path's 53 BN layers, beside the bound. Phase 1's
    library call, ``batch_norm_backward_reduce``, computes the same
    function as the fused phase 1 for the 20 layers without ReLU (the
    sums, grad_weight and grad_bias); the port never calls it."""
    from deeplearning4j_tpu_torch.kernels import bn_relu
    bw, flops = card_rates(card_name)
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    counts = {}
    for c in per_step:
        counts[c] = counts.get(c, 0) + 1
    tot = {bn_relu.kernel_name(p, r): {"ms": 0.0, "plain_ms": 0.0,
                                       "bound_bytes": 0.0, "ops": 0.0,
                                       "library_ms": None}
           for p in (1, 2) for r in (True, False)}
    native_ms = 0.0
    for (shape, relu, dtype, cl_dy, gdtype), cnt in sorted(counts.items()):
        n, c, h, w = shape
        x, dy, gamma, mean, inv, a, b = bn_inputs(
            (n, h, w, c), getattr(torch, dtype), relu, dev,
            nchw_dy=not cl_dy, gdtype=getattr(torch, gdtype))
        check_kernels(x, dy, gamma, mean, inv, a, b, relu, errs,
                      f"path {shape} {dtype} gamma {gdtype} "
                      f"relu={int(relu)} dy={'NHWC' if cl_dy else 'NCHW'}")
        s1, s2 = bn_relu.phase1_plain(x, dy, a, b, mean, relu)
        _, _, g, c1, c2 = bn_relu.phase1_fold_plain(x, dy, a, b, mean, inv,
                                                    gamma, relu)
        es, rc = x.element_size(), x.numel()
        gs, acc = gamma.element_size(), mean.element_size()
        iters = 10 if rc > 2e7 else 30
        k1 = time_ms(lambda: bn_relu.bn_bwd_phase1(x, dy, a, b, mean, inv,
                                                   gamma, relu),
                     flush, iters)
        p1 = time_ms(lambda: bn_relu.phase1_fold_plain(
            x, dy, a, b, mean, inv, gamma, relu), flush, iters)
        k2 = time_ms(lambda: bn_relu.bn_bwd_phase2(x, dy, a, b, mean, g, c1,
                                                   c2, relu), flush, iters)
        p2 = time_ms(lambda: bn_relu.phase2_plain(x, dy, a, b, mean, g, c1,
                                                  c2, relu), flush, iters)
        # bytes the function must move: x and dy read once, dx written
        # once; the per-channel vectors in (a, b, mean, inv, gamma; g, c1,
        # c2 for phase 2) and out (dgamma, dbeta, g, c1, c2 for phase 1)
        b1 = 2 * rc * es + c * (2 * es + 2 * acc + gs) + c * (2 * gs +
                                                              3 * acc)
        b2 = 3 * rc * es + c * (2 * es + 4 * acc)
        o1 = rc * (9 if relu else 4)       # mask (mul, add, cmp, select)
        o2 = rc * (9 if relu else 4)       # + sub, mul, sub, mul
        lib = ""
        for phase, k, p, by, op in ((1, k1, p1, b1, o1), (2, k2, p2, b2, o2)):
            t = tot[bn_relu.kernel_name(phase, relu)]
            t["ms"] += cnt * k
            t["plain_ms"] += cnt * p
            t["bound_bytes"] += cnt * by
            t["ops"] += cnt * op
        if not relu:
            # the library's kernels take dy in x's layout, and a float32
            # weight beside bf16 input
            dy = dy.contiguous(memory_format=torch.channels_last)
            wf = gamma.float()
            cnt_t = torch.tensor([n * h * w], dtype=torch.int32, device=dev)
            l1 = time_ms(lambda: torch.ops.aten.batch_norm_backward_reduce(
                dy, x, mean, inv, wf, True, True, True), flush, iters)
            l2 = time_ms(lambda: torch.ops.aten.batch_norm_backward_elemt(
                dy, x, mean, inv, wf, s1, s2, cnt_t), flush, iters)
            ln = time_ms(lambda: torch.ops.aten.native_batch_norm_backward(
                dy, x, wf, None, None, mean, inv, True, 1e-5,
                [True, True, True]), flush, iters)
            for phase, lt in ((1, l1), (2, l2)):
                t = tot[bn_relu.kernel_name(phase, False)]
                t["library_ms"] = (t["library_ms"] or 0.0) + cnt * lt
            native_ms += cnt * ln
            lib = (f" | library reduce {l1:.4f} elemt {l2:.4f} "
                   f"native_batch_norm_backward {ln:.4f}")
        log(f"  {shape} relu={int(relu)} dy={'NHWC' if cl_dy else 'NCHW'} "
            f"x{cnt}: phase1 {k1:.4f} ms (plain {p1:.4f}, bound "
            f"{1e3 * b1 / bw:.4f}) phase2 {k2:.4f} ms (plain {p2:.4f}, "
            f"bound {1e3 * b2 / bw:.4f}){lib}")
        del x, dy
    # what every "alone" time carries besides the kernel: a one-element
    # fill timed the same way (launch and event overhead, L2 write-back)
    tiny = torch.empty(1, device=dev)
    floor = time_ms(lambda: tiny.zero_(), flush, 30)
    log(f"  timing floor: a one-element fill timed the same way takes "
        f"{1e3 * floor:.1f} us; x53 BN layers = {53 * floor:.3f} ms per "
        f"step in each 'alone' sum")
    # the host's side of a phase-1 call (the step is host-bound)
    n, c, h, w = per_step[0][0]
    x, dy, gamma, mean, inv, a, b = bn_inputs(
        (n, h, w, c), getattr(torch, per_step[0][2]), True, dev,
        gdtype=getattr(torch, per_step[0][4]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        bn_relu.bn_bwd_phase1(x, dy, a, b, mean, inv, gamma, True)
    host_us = 1e6 * (time.perf_counter() - t0) / 200
    torch.cuda.synchronize()
    log(f"  host time of a phase-1 call (wrapper, checks, ctypes launch): "
        f"{host_us:.1f} us at {per_step[0][0]}")
    del x, dy
    out = {}
    for name, t in tot.items():
        by_bytes, by_ops = 1e3 * t["bound_bytes"] / bw, 1e3 * t["ops"] / flops
        out[name] = dict(t, bound_ms=max(by_bytes, by_ops),
                         bound_by="bytes" if by_bytes >= by_ops
                         else "operations")
    log(f"  per step, the 20 BN layers without ReLU: "
        f"native_batch_norm_backward {native_ms:.3f} ms")
    return out, native_ms


# ----------------------------------------------------------------------
def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    from deeplearning4j_tpu_torch.environment import card_info
    card = card_info()
    name = torch.cuda.get_device_name(0)

    log("[1/5] env")
    import triton
    from deeplearning4j_tpu_torch.kernels import _cuda, bn_relu
    log(f"  python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"CUDA {torch.version.cuda}  triton {triton.__version__}")
    log(f"  nvcc: {_cuda.nvcc_version()}")
    log(f"  card: {card}  ({torch.cuda.device_count()} visible)")
    t0 = time.perf_counter()
    bn_relu._phase1_lib()
    build = _cuda.BUILDS.get(bn_relu._PHASE1_LIB)
    log(f"  csrc/{bn_relu._PHASE1_LIB}.cu: " + (
        f"built in {build['seconds']:.1f} s" if build else
        f"already built, loaded in {time.perf_counter() - t0:.1f} s"))
    for line in (build or {}).get("log", "").splitlines():
        if "entry function" in line or "registers" in line or \
                "spill" in line:
            log(f"    {line.strip()}")

    log("[2/5] kernels: BN(+ReLU) backward vs plain, on the card "
        "(phase 1 CUDA C++, phase 2 Triton)")
    t0 = time.perf_counter()
    errs = {}
    phase_kernels(dev, errs)
    log(f"  ({time.perf_counter() - t0:.1f} s, builds included)")

    log("[3/5] parity: ResNet-50 32x32, two fit steps, card vs CPU")
    t0 = time.perf_counter()
    phase_parity()
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    log(f"[4/5] main path: ResNet-50 224x224 bs{BATCH} bf16 "
        f"ComputationGraph.fit on the card")
    t0 = time.perf_counter()
    per_step, launches, metrics = phase_main(dev, card)
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    log("[5/5] path shapes: kernels vs plain, then timed (ms per step)")
    t0 = time.perf_counter()
    timing, _ = phase_timing(dev, per_step, name, errs)
    in_situ = metrics["profile"]["kernel_ms"]
    for label, ms in (("timed alone, L2 cold", sum(
            t["ms"] for t in timing.values())), ("in the step (profiler)",
                                                  sum(in_situ.values()))):
        log(f"  BN backward kernels, {label}: {ms:.3f} ms of a "
            f"{metrics['step_ms']:.2f} ms step "
            f"({ms / metrics['step_ms']:.3f})  [{card}]")
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    kernels = []
    for kname, t in timing.items():
        route, source = ROUTE[int(kname[-1])]
        kernels.append({
            "name": kname, "route": route, "source": source,
            "replaces": REPLACES[int(kname[-1])],
            "launches": launches[kname],
            "launches_per_step": launches[kname] // STEPS,
            "max_abs_err": errs[kname],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "ms_per": "training step",
            "in_step_ms": in_situ[kname]})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
