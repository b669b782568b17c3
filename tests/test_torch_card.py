"""The port's kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and skips without a card; none imports
JAX, so the file runs on a machine that has only the port's
dependencies: ``python -m pytest tests/test_torch_card.py -m cuda``.
Tolerance: 1e-5 of the largest magnitude for float32 and 1e-12 for
float64 (the same arithmetic; only the order of the sums differs), 1e-2
for bf16 (dx is rounded to 8 bits). Phase 1's sum-derived outputs are
held per channel to 1e-5 of the sum of the absolute terms behind them
(1e-12 in float64), plus, for dgamma and dbeta in a bf16 gamma's dtype,
one unit in its last place (one rounding to 8 bits); g = gamma * inv to
one unit in its last place.
"""
import math

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.kernels import bn_relu

EPS = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA C++ and Triton kernels "
                    "have no CPU mode")
    return torch.device("cuda")


def _close(a, b, rtol):
    a, b = a.double().cpu(), b.double().cpu()
    assert a.shape == b.shape
    err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
    assert err <= rtol, err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", [(3, 100, 7, 9), (8, 256, 14, 14)])
def test_kernels_match_plain_on_card(card, shape, relu, dtype):
    rng = np.random.default_rng(5)
    c = shape[1]
    x = torch.as_tensor(rng.normal(size=shape)
                        + 2 * rng.normal(size=(1, c, 1, 1)))
    x = x.to(card, dtype).contiguous(memory_format=torch.channels_last)
    dy = torch.as_tensor(rng.normal(size=shape)).to(card, dtype)  # NCHW
    sdt = torch.float64 if dtype == torch.float64 else torch.float32
    g = torch.as_tensor(1 + 0.1 * rng.normal(size=c), dtype=sdt,
                        device=card)
    b = torch.as_tensor(0.1 * rng.normal(size=c), dtype=sdt, device=card)
    _, mean, _, inv, a, bb = bn_relu.bn_train_forward(x, g, b, EPS, relu)
    names = [bn_relu.kernel_name(p, relu) for p in (1, 2)]
    before = [bn_relu.LAUNCHES[n] for n in names]
    got = bn_relu.bn_relu_bwd(x, dy, g, mean, inv, a, bb, relu)
    want = bn_relu.bn_relu_bwd_plain(x, dy, g, mean, inv, a, bb, relu)
    torch.cuda.synchronize()
    assert [bn_relu.LAUNCHES[n] for n in names] == [n + 1 for n in before]
    assert got[0].stride() == x.stride()
    tol = {torch.float32: 1e-5, torch.float64: 1e-12}.get(dtype, 1e-2)
    for k, p in zip(got, want):
        _close(k, p, tol)


def _bn_case(card, shape, dtype, gdtype, relu, nchw_dy, seed=6):
    """x channels-last (N, C, H, W) with a per-channel offset, dy (NCHW
    layout if asked), gamma in ``gdtype``, and the forward's statistics."""
    rng = np.random.default_rng(seed)
    c = shape[1]
    x = torch.as_tensor(rng.normal(size=shape)
                        + 2 * rng.normal(size=(1, c, 1, 1)))
    x = x.to(card, dtype).contiguous(memory_format=torch.channels_last)
    dy = torch.as_tensor(rng.normal(size=shape)).to(card, dtype)
    if not nchw_dy:
        dy = dy.contiguous(memory_format=torch.channels_last)
    g = torch.as_tensor(1 + 0.1 * rng.normal(size=c)).to(card, gdtype)
    b = torch.as_tensor(0.1 * rng.normal(size=c)).to(card, gdtype)
    _, mean, _, inv, a, bb = bn_relu.bn_train_forward(x, g, b, EPS, relu)
    return x, dy, g, b, mean, inv, a, bb


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,gdtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.float32), (torch.float64, torch.float64)])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape,nchw_dy", [
    ((3, 100, 7, 9), True), ((3, 100, 7, 9), False), ((4, 64, 8, 8), True),
    ((128, 512, 7, 7), False), ((128, 2048, 7, 7), False)])
def test_fused_phase1_matches_its_plain_version(card, shape, nchw_dy, relu,
                                                dtype, gdtype):
    """The five outputs of the one-launch phase 1 (the ragged shape, an
    NCHW dy, stage 5 of ResNet-50), against ``phase1_fold_plain``; two
    calls bit-equal; one launch each."""
    x, dy, g, _, mean, inv, a, bb = _bn_case(card, shape, dtype, gdtype,
                                             relu, nchw_dy)
    name = bn_relu.kernel_name(1, relu)
    before = bn_relu.LAUNCHES[name]
    got = bn_relu.bn_bwd_phase1(x, dy, a, bb, mean, inv, g, relu)
    again = bn_relu.bn_bwd_phase1(x, dy, a, bb, mean, inv, g, relu)
    want = bn_relu.phase1_fold_plain(x, dy, a, bb, mean, inv, g, relu)
    torch.cuda.synchronize()
    assert bn_relu.LAUNCHES[name] == before + 2
    assert all(torch.equal(p, q) for p, q in zip(got, again))
    dz = bn_relu._masked_dy(x, dy, a, bb, relu)
    red = bn_relu._red(x)
    t1 = dz.abs().sum(red).double()
    t2 = (dz * (bn_relu._up(x) - bn_relu._chan(mean, x))).abs().sum(
        red).double()
    r, iv = x.numel() // x.shape[1], inv.double()
    rel = 1e-12 if dtype == torch.float64 else 1e-5
    for k, w, terms in zip(got, want, (iv * t2, t1, None, t1 / r,
                                       iv * iv * t2 / r)):
        assert k.dtype == w.dtype and k.shape == w.shape
        err = (k.double() - w.double()).abs()
        ulp = torch.finfo(w.dtype).eps * w.double().abs()
        tol = ulp if terms is None else rel * terms + (
            ulp if w.dtype != mean.dtype else 0.0)
        assert bool((err <= tol).all()), float((err - tol).max())


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [True, False])
def test_bn_backward_is_two_device_launches(card, relu):
    """The whole backward of one BN layer, as autograd runs it on the main
    path (bf16 x, bf16 gamma): the phase-1 kernel and the phase-2 kernel,
    and no other device work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x, dy, g, b, _, _, _, _ = _bn_case(card, (32, 256, 14, 14),
                                       torch.bfloat16, torch.bfloat16, relu,
                                       False)
    x.requires_grad_(True)
    g.requires_grad_(True)
    b.requires_grad_(True)
    out, _, _ = bn_relu.BatchNormTrain.apply(x, g, b, EPS, relu)
    torch.autograd.grad(out, (x, g, b), dy, retain_graph=True)   # builds
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dx, dg, db = torch.autograd.grad(out, (x, g, b), dy)
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    names = sorted(e.key for e in device)
    assert sum(e.count for e in device) == 2, names
    assert names[0].startswith(bn_relu.kernel_name(1, relu) + "_")
    assert names[1] == bn_relu.kernel_name(2, relu)
    assert dg.dtype == db.dtype == torch.bfloat16


@pytest.mark.cuda
def test_kernels_refuse_float16(card):
    x = torch.zeros(8, 4, dtype=torch.float16, device=card)
    v = torch.zeros(4, dtype=torch.float16, device=card)
    with pytest.raises(ValueError, match="does not take"):
        bn_relu.bn_bwd_phase1(x, x, v, v, v.float(), v.float(), v, True)
    with pytest.raises(ValueError, match="does not take"):
        bn_relu.bn_bwd_phase2(x, x, v, v, v.float(), v.float(), v.float(),
                              v.float(), True)


@pytest.mark.cuda
def test_resnet_step_runs_every_bn_backward_through_the_kernels(card):
    from deeplearning4j_tpu_torch.autodiff import MixedPrecision
    from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
    from deeplearning4j_tpu_torch.nn import ComputationGraph
    from deeplearning4j_tpu_torch.zoo import ResNet50
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 3, 32, 32)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 8)]
    conf = ResNet50(height=32, width=32, num_classes=4).conf()
    conf.mixed_precision = MixedPrecision()
    net = ComputationGraph(conf).init()
    it = DeviceCachedIterator(x, y, batch_size=8)
    # the first fit warms up (two eager steps, which launch) and captures
    # the one-step epoch; the second replays it
    net.fit(it)
    bn_relu.reset_launches()
    loss = net.fit(it).final_loss()
    assert np.isfinite(loss)
    assert net.last_fit_stats["graph_replays_per_epoch"] == 1
    # 53 + 53: one phase-1 and one phase-2 launch per BN backward
    assert bn_relu.LAUNCHES == {"bn_relu_bwd_phase1": 33,
                                "bn_relu_bwd_phase2": 33,
                                "bn_bwd_phase1": 20, "bn_bwd_phase2": 20}


# ----------------------------------------------------------------------
# attention (csrc/causal_attention.cu) against its plain versions
def _attn_inputs(card, b, h, sq, sk, d, dtype, seed=7, split=False):
    """q, k, v, dO from a seeded rng; with ``split`` q, k and v are the
    strided views ``build_gpt`` hands the op (one [B, S, H, 3D] tensor,
    permuted and split)."""
    rng = np.random.default_rng(seed)
    if split:
        qkv = torch.as_tensor(rng.normal(size=(b, sq, h, 3 * d))).to(
            card, dtype).permute(0, 2, 1, 3)
        q, k, v = torch.split(qkv, d, dim=3)
    else:
        q, k, v = (torch.as_tensor(rng.normal(size=(b, h, s, d))).to(
            card, dtype) for s in (sq, sk, sk))
    do = torch.as_tensor(rng.normal(size=(b, h, sq, d))).to(card, dtype)
    return q, k, v, do


def _attn_grads(fn, q, k, v, do, causal):
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    o = fn(q, k, v, causal=causal)
    return (o.detach(),) + torch.autograd.grad(o, (q, k, v), do)


ATTN_CASES = [  # (b, h, sq, sk, d, causal, split)
    (2, 3, 77, 77, 64, True, False),
    (1, 2, 200, 200, 16, True, False),
    (1, 1, 1, 1, 64, True, False),
    (2, 2, 96, 96, 32, False, False),
    (1, 2, 50, 130, 64, True, False),      # Sq < Sk
    (1, 2, 130, 50, 64, True, False),      # Sq > Sk: fully masked rows
    (2, 3, 128, 128, 128, True, True),     # build_gpt's strided q, k, v
    # the bf16 kernels' tile edges: 128-query and 64-key tiles
    (1, 2, 127, 127, 16, True, False),
    (1, 2, 128, 128, 32, False, False),
    (1, 2, 129, 129, 64, True, False),
    (1, 2, 257, 257, 128, True, False),
    (1, 2, 129, 257, 128, True, False),    # Sq < Sk
    (1, 2, 257, 129, 64, True, False),     # Sq > Sk
    (1, 2, 128, 127, 32, True, False),     # Sq > Sk by one
    (1, 2, 127, 129, 16, False, False),
    (1, 2, 257, 257, 64, True, True),
    (1, 2, 129, 129, 128, False, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float64])
def test_attention_kernels_match_plain_on_card(card, case, dtype):
    """O and the three grads through the kernels (``Attention``) against
    the autograd of ``sdpa_plain``. float32 and float64: within 1e-5 and
    1e-10 of the sum of the absolute terms behind each element (the same
    terms summed in another order). bf16: both the kernels and the bf16
    plain version are held to ``sdpa_plain`` in float32 on the same bf16
    inputs; the kernels' error is at most twice the plain version's plus
    one bf16 unit in the last place of the output's magnitude, plus the
    float32 allowance of 1e-5 of the largest sum of absolute terms (the
    kernels sum in float32 in another order: a one-key softmax's
    gradient, exactly 0 in the reference, comes out at 1e-7). Two calls
    are bit-equal; one forward and three backward launches a call, the
    forward float32's from ``attention_f32``."""
    from deeplearning4j_tpu_torch.kernels import attention as at
    from deeplearning4j_tpu_torch.kernels import attention_f32 as af
    b, h, sq, sk, d, causal, split = case
    q, k, v, do = _attn_inputs(card, b, h, sq, sk, d, dtype, split=split)
    before = dict(at.LAUNCHES)
    before_f32 = af.LAUNCHES["attention_fwd_f32"]
    got = _attn_grads(at.scaled_dot_product_attention, q, k, v, do, causal)
    again = _attn_grads(at.scaled_dot_product_attention, q, k, v, do, causal)
    torch.cuda.synchronize()
    f32 = dtype == torch.float32
    assert {n: at.LAUNCHES[n] - before[n] for n in before} == {
        n: 0 if f32 and n == "attention_fwd" else 2 for n in before}
    assert af.LAUNCHES["attention_fwd_f32"] - before_f32 == (2 if f32 else 0)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    if dtype == torch.bfloat16:
        f = [t.float() for t in (q, k, v, do)]
        ref = _attn_grads(at.sdpa_plain, *f[:3], f[3], causal)
        plain = _attn_grads(at.sdpa_plain, q, k, v, do, causal)
        terms = at.abs_terms(q, k, v, do, causal)
        for x, p, r, t in zip(got, plain, ref, terms):
            ek = float((x.float() - r).abs().max())
            ep = float((p.float() - r).abs().max())
            mag = float(r.abs().max())
            ulp = 2.0 ** (math.floor(math.log2(mag)) - 7) if mag > 0 else 0
            assert ek <= 2 * ep + ulp + 1e-5 * float(t.max()), (ek, ep, ulp)
    else:
        want = _attn_grads(at.sdpa_plain, q, k, v, do, causal)
        terms = at.abs_terms(q, k, v, do, causal)
        rel = 1e-10 if dtype == torch.float64 else 1e-5
        for x, w, t in zip(got, want, terms):
            assert x.dtype == w.dtype and x.shape == w.shape
            err = (x.double() - w.double()).abs()
            assert bool((err <= rel * t + 1e-300).all()), float(
                (err / t.clamp_min(1e-300)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float64])
def test_each_attention_kernel_matches_its_plain_version_on_card(card, case,
                                                                  dtype):
    """Each kernel against its plain version on the same inputs (the
    backward kernels get the forward kernel's stats and the delta kernel's
    delta), per element to a share of the sum of the absolute terms behind
    it: 2^-6 in bf16 (each side rounds every P or dS term once and its
    output once, but not the same values: 4 units of bf16's roundoff),
    1e-5 in float32 and 1e-10 in float64 (the same terms summed in another
    order); delta, a float32 (float64) sum, to 1e-5 (1e-10) in every
    dtype. Two calls bit-equal."""
    from deeplearning4j_tpu_torch.kernels import attention as at
    b, h, sq, sk, d, causal, split = case
    q, k, v, do = _attn_inputs(card, b, h, sq, sk, d, dtype, split=split)
    s = 1.0 / math.sqrt(d)
    acc = at.acc_dtype(dtype)

    def run():
        o, st = at.attention_fwd(q, k, v, causal)
        delta = torch.empty(q.shape[:3], dtype=acc, device=card)
        at._launch("dl4j_attention_bwd_delta", q, k, v, s, causal, o=o,
                   dout=do, stats=st, delta=delta)
        dk, dv = torch.empty_like(k, memory_format=torch.contiguous_format), \
            torch.empty_like(v, memory_format=torch.contiguous_format)
        at._launch("dl4j_attention_bwd_dkdv", q, k, v, s, causal, o=o,
                   dout=do, stats=st, delta=delta, dk=dk, dv=dv)
        dq = torch.empty_like(q, memory_format=torch.contiguous_format)
        at._launch("dl4j_attention_bwd_dq", q, k, v, s, causal, o=o,
                   dout=do, stats=st, delta=delta, dq=dq)
        return o, st, delta, dk, dv, dq

    got, again = run(), run()
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    o, st, delta, dk, dv, dq = got
    rel = {torch.bfloat16: 2.0 ** -6, torch.float32: 1e-5,
           torch.float64: 1e-10}[dtype]
    rel_acc = 1e-10 if dtype == torch.float64 else 1e-5
    t_o, t_dq, t_dk, t_dv = at.abs_terms(q, k, v, do, causal)
    pdk, pdv = at.bwd_dkdv_plain(q, k, v, do, st, delta, causal)
    for x, want, t, r in (
            (o, at.attention_fwd_plain(q, k, v, causal)[0], t_o, rel),
            (delta, at.bwd_delta_plain(o, do),
             (do.double().abs() * o.double().abs()).sum(-1), rel_acc),
            (dk, pdk, t_dk, rel), (dv, pdv, t_dv, rel),
            (dq, at.bwd_dq_plain(q, k, v, do, st, delta, causal), t_dq, rel)):
        err = (x.double() - want.double()).abs()
        assert bool((err <= r * t + 1e-300).all()), float(
            (err / (r * t).clamp_min(1e-300)).max())


@pytest.mark.cuda
def test_attention_copies_bf16_views_whose_rows_are_not_on_16_bytes(card):
    """TMA reads only tensors whose base and strides are 16-byte
    multiples: the wrappers copy a bf16 q, k, v (rows 130 bytes apart) and
    a dO (2 bytes into its storage), count each copy, and give O, stats and
    the grads of the same values laid out contiguously, bit for bit."""
    from deeplearning4j_tpu_torch.kernels import attention as at
    q, k, v, do = _attn_inputs(card, 1, 2, 129, 129, 64, torch.bfloat16)
    wide = [torch.zeros(1, 2, 129, 65, dtype=torch.bfloat16, device=card)
            for _ in range(3)]
    for w, t in zip(wide, (q, k, v)):
        w[..., :64] = t
    qo, ko, vo = (w[..., :64] for w in wide)
    flat = torch.zeros(do.numel() + 1, dtype=torch.bfloat16, device=card)
    doo = flat[1:].view(do.shape)
    doo.copy_(do)
    assert not at._rows_aligned([qo]) and not at._rows_aligned([doo])
    at.reset_launches()
    got = at.attention_fwd(qo, ko, vo, True)
    got = got + at.attention_bwd(qo, ko, vo, got[0], doo, got[1], True)
    assert at.ALIGN_COPIES == {"attention_fwd": 3, "attention_bwd": 3}
    assert at.DOUT_COPIES["attention_bwd"] == 1
    o, st = at.attention_fwd(q, k, v, True)
    want = (o, st) + at.attention_bwd(q, k, v, o, do, st, True)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.cuda
def test_attention_on_two_streams_at_once_gives_one_streams_bits(card):
    """The persistent bf16 kernels take their work items from a counter of
    their launch's stream. Forward and backward on two streams at once, at
    two shapes (grids of one block per SM and of 9 blocks), give the bits
    they give on one stream, call after call; the one-stream results are
    held to the plain versions (2^-6 of the sum of the absolute terms)."""
    from deeplearning4j_tpu_torch.kernels import attention as at
    cases = [_attn_inputs(card, 4, 12, 512, 512, 128, torch.bfloat16,
                          split=True),
             _attn_inputs(card, 1, 3, 257, 129, 64, torch.bfloat16, seed=8)]

    def fwd_bwd(q, k, v, do):
        o, st = at.attention_fwd(q, k, v, True)
        return (o, st) + at.attention_bwd(q, k, v, o, do, st, True)

    want = [fwd_bwd(*c) for c in cases]
    for (q, k, v, do), (o, st, dq, dk, dv) in zip(cases, want):
        terms = at.abs_terms(q, k, v, do, True)
        plain = (at.attention_fwd_plain(q, k, v, True)[0],) + \
            at.attention_bwd_plain(q, k, v, o, do, st, True)
        for x, p, t in zip((o, dq, dk, dv), plain, terms):
            err = (x.double() - p.double()).abs()
            assert bool((err <= 2.0 ** -6 * t + 1e-300).all())
    streams = [torch.cuda.Stream(card) for _ in cases]
    torch.cuda.synchronize()
    got = [[] for _ in cases]
    for _ in range(8):
        for c, s, g in zip(cases, streams, got):
            with torch.cuda.stream(s):
                g.append(fwd_bwd(*c))
    torch.cuda.synchronize()
    for w, g in zip(want, got):
        for r in g:
            assert all(torch.equal(x, y) for x, y in zip(r, w))


@pytest.mark.cuda
def test_attention_refuses_what_it_does_not_take(card):
    from deeplearning4j_tpu_torch.kernels import attention as at
    q = torch.zeros(1, 1, 4, 64, dtype=torch.float16, device=card)
    with pytest.raises(ValueError, match="does not take"):
        at.attention_fwd(q, q, q, True)
    q = torch.zeros(1, 1, 4, 48, dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        at.attention_fwd(q, q, q, True)
    q = torch.zeros(1, 1, 64, 4, dtype=torch.bfloat16,
                    device=card).transpose(2, 3)
    with pytest.raises(ValueError, match="last stride"):
        at.attention_fwd(q, q, q, True)
    q = torch.zeros(1, 1, 4, 64, dtype=torch.bfloat16, device=card)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        at.scaled_dot_product_attention(q, q, q, mask=torch.ones(
            4, 4, device=card))


@pytest.mark.cuda
def test_attention_backward_copies_a_dout_with_a_strided_last_axis(card):
    from deeplearning4j_tpu_torch.kernels import attention as at
    q, k, v, do = _attn_inputs(card, 1, 2, 64, 64, 64, torch.float32)
    o, stats = at.attention_fwd(q, k, v, True)
    odd = do.transpose(2, 3).contiguous().transpose(2, 3)
    before = at.DOUT_COPIES["attention_bwd"]
    got = at.attention_bwd(q, k, v, o, odd, stats, True)
    want = at.attention_bwd(q, k, v, o, do, stats, True)
    assert at.DOUT_COPIES["attention_bwd"] == before + 1
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.cuda
def test_gpt_tiny_step_runs_every_attention_through_the_kernels(card):
    """One bf16 SameDiff.fit step of GPT_TINY (2 layers, remat): the
    forward kernel twice per layer (forward and the remat re-forward),
    each backward kernel once per layer, and no dO copy. The
    ``DeviceCachedIterator`` takes the scanned tier: its first fit runs
    the warm-up steps eagerly and replays the captured step once, a later
    fit replays it once, and the wrappers count each launch there; the
    per-step tier (a list of batches) counts the same."""
    from deeplearning4j_tpu_torch.autodiff import (MixedPrecision,
                                                   TrainingConfig)
    from deeplearning4j_tpu_torch.autodiff.window import WARMUP_STEPS
    from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
    from deeplearning4j_tpu_torch.kernels import attention as at
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.zoo import GPT_TINY, build_gpt
    rng = np.random.default_rng(0)
    ids, tgt = (rng.integers(0, 256, (4, 32)).astype(np.int32)
                for _ in range(2))
    sd = build_gpt(GPT_TINY, batch=4, seq_len=32)
    sd.training_config = TrainingConfig(
        updater=Adam(1e-3), data_set_feature_mapping=["input_ids"],
        data_set_label_mapping=["targets"], mixed_precision=MixedPrecision())
    step = {"attention_fwd": 4, "attention_bwd_delta": 2,
            "attention_bwd_dkdv": 2, "attention_bwd_dq": 2}
    it = DeviceCachedIterator([ids], [tgt], batch_size=4)
    for data, tier, steps in ((it, "scanned_epoch", WARMUP_STEPS + 1),
                              (it, "scanned_epoch", 1),
                              (list(it), "per_step", 1)):
        at.reset_launches()
        loss = sd.fit(data).final_loss()
        torch.cuda.synchronize()
        assert sd.last_fit_stats["tier"] == tier
        assert np.isfinite(loss)
        assert at.LAUNCHES == {k: steps * n for k, n in step.items()}
        assert at.DOUT_COPIES["attention_bwd"] == 0
        assert at.ALIGN_COPIES == {"attention_fwd": 0, "attention_bwd": 0}


@pytest.mark.cuda
def test_gpt_tiny_float64_step_on_card_matches_cpu(card):
    """float64 gradients of GPT_TINY through the kernels' float64 path,
    against the CPU's plain versions: 1e-10 of each tensor's magnitude."""
    from deeplearning4j_tpu_torch.zoo import GPT_TINY, build_gpt
    rng = np.random.default_rng(1)
    feed = {"input_ids": rng.integers(0, 256, (4, 32)).astype(np.int32),
            "targets": rng.integers(0, 256, (4, 32)).astype(np.int32)}
    grads = []
    for dev in ("cuda", "cpu"):
        sd = build_gpt(GPT_TINY, batch=4, seq_len=32, device=dev)
        for n, a in sd.trainable_params().items():
            sd.set_arr_for_var(n, a.double())
        grads.append(sd.calculate_gradients(feed))
    for name, want in grads[1].items():
        got = grads[0][name].cpu()
        assert got.dtype == torch.float64
        _close(got, want, 1e-10)


# ----------------------------------------------------------------------
# paged attention (csrc/paged_attention.cu)
PAGED_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _paged_all(args):
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    return (pa.paged_attention(*args), pa.paged_attention_plain(*args),
            pa.abs_terms(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("bs", [1, 8, 16, 160, 1024])
def test_paged_decode_kernel_matches_plain_on_card(card, bs, d, dtype):
    """Each row within 1e-5 (float32) or 1e-12 (float64) of the sum of its
    absolute terms of the plain version; last keys 0, at block edges (15,
    16, 17), inside a partly filled last block and at 1023."""
    from deeplearning4j_tpu_torch.kernels import measure
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    args = measure.paged_decode_case(card, [0, 15, 16, 17, 300, 1023], 3,
                                     d, bs, dtype, seed=bs + d)
    before = pa.LAUNCHES["paged_attention"]
    got, want, terms = _paged_all(args)
    torch.cuda.synchronize()
    assert pa.LAUNCHES["paged_attention"] == before + 1
    assert measure.paged_reading(got, want, terms, PAGED_TOL[dtype]) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("hist,rows,length", [(0, 64, 50), (48, 32, 32),
                                              (256, 512, 500)])
def test_paged_prefill_kernel_matches_plain_on_card(card, hist, rows,
                                                    length, dtype):
    from deeplearning4j_tpu_torch.kernels import measure
    args = measure.paged_prefill_case(card, hist, rows, length, 4, 64, 16,
                                      dtype, seed=hist)
    got, want, terms = _paged_all(args)
    assert measure.paged_reading(got[:length], want[:length],
                                 terms[:length], PAGED_TOL[dtype]) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [1, 16, 160])
def test_paged_kernel_bits_two_calls_dense_and_nan_poison(card, bs):
    """Two calls give the same bits; the dense slab of the same contexts
    gives the same bits; NaN in the null block, the unused blocks and past
    each lane's last key changes nothing."""
    from deeplearning4j_tpu_torch.kernels import measure
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    q, kc, vc, tables, lane, kmax = measure.paged_decode_case(
        card, [0, 16, 37, 200, 511, 1023, 5, 77], 12, 128, bs,
        torch.float32, seed=3)
    out = pa.paged_attention(q, kc, vc, tables, lane, kmax)
    assert torch.equal(out, pa.paged_attention(q, kc, vc, tables, lane,
                                               kmax))
    dk, dv, dt = measure.paged_dense(kc, vc, tables)
    assert torch.equal(out, pa.paged_attention(q, dk, dv, dt, lane, kmax))
    pk, pv = measure.paged_poisoned(kc, vc, tables, lane, kmax)
    poisoned = pa.paged_attention(q, pk, pv, tables, lane, kmax)
    assert torch.isfinite(poisoned).all() and torch.equal(poisoned, out)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("bs", [1, 16, 1024])
def test_paged_decode_write_kernel_matches_plain_on_card(card, bs, d, dtype):
    """``paged_decode_attention`` (the step's K/V write, then attention),
    one launch: each row within 1e-5 (float32) or 1e-12 (float64) of the
    sum of its absolute terms of the plain version (``index_put_``, then
    the attention); the cache after the write bit-equal to the plain
    write's; a second call gives the same bits; NaN where the step writes
    changes nothing."""
    from deeplearning4j_tpu_torch.kernels import measure
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    case = measure.paged_decode_write_case(
        card, [0, 15, 16, 17, 300, 1023], 3, d, bs, dtype,
        active=[True, True, False, True, True, True], seed=bs + d)
    q, k_new, v_new, kc, vc, tables, lane, kmax, wb, wo = case
    before = pa.LAUNCHES["paged_decode_attention"]
    outs = []
    for fn, (k_, v_) in ((pa.paged_decode_attention, (kc.clone(), vc.clone())),
                         (pa.paged_decode_attention, (kc.clone(), vc.clone())),
                         (pa.paged_decode_plain, (kc.clone(), vc.clone())),
                         (pa.paged_decode_attention,
                          measure.paged_write_poisoned(kc, vc, wb, wo))):
        outs.append((fn(q, k_new, v_new, k_, v_, tables, lane, kmax, wb, wo),
                     k_, v_))
    torch.cuda.synchronize()
    assert pa.LAUNCHES["paged_decode_attention"] == before + 3
    (got, gk, gv), (again, _, _), (want, wk, wv), (pois, _, _) = outs
    terms = pa.abs_terms(q, wk, wv, tables, lane, kmax)
    assert measure.paged_reading(got, want, terms, PAGED_TOL[dtype]) <= 1
    assert torch.equal(gk, wk) and torch.equal(gv, wv)
    assert torch.equal(got, again) and torch.equal(pois, got)


@pytest.mark.cuda
def test_paged_serving_on_card_matches_cpu_in_float64(card):
    """GPT_TINY in float64 through PagedGenerativeServer on the card and
    on the CPU, a prefix hit among the prompts: the same greedy tokens."""
    from deeplearning4j_tpu_torch.serving.paged import PagedGenerativeServer
    from deeplearning4j_tpu_torch.zoo import (GPT_TINY, build_gpt,
                                              gpt_paged_spec)
    rng = np.random.default_rng(2)
    shared = rng.integers(0, 256, 20).astype(np.int32)
    prompts = [shared, np.concatenate([shared, [7, 9]]).astype(np.int32),
               rng.integers(0, 256, 5).astype(np.int32)]
    toks = []
    for dev in ("cuda", "cpu"):
        sd = build_gpt(GPT_TINY, batch=2, seq_len=8, device=dev)
        for n, a in sd.trainable_params().items():
            sd.set_arr_for_var(n, a.double())
        with PagedGenerativeServer(gpt_paged_spec(sd, GPT_TINY),
                                   max_slots=2, block_size=8, warmup=False,
                                   device=dev) as srv:
            toks.append([srv.submit(p, max_new_tokens=12).result(timeout=120)
                         for p in prompts])
            assert srv.metrics.counters["prefix_hits"] >= 1
    assert toks[0] == toks[1]


# ----------------------------------------------------------------------
# float32 attention on the tensor cores (csrc/attention_f32.cu)
F32_CASES = [  # (b, h, sq, sk, d, causal, split)
    (1, 12, 512, 512, 128, True, True),   # the dense prefill's serving shape
    (1, 2, 63, 63, 16, True, False),      # 64-row tiles, 32/64-key tiles
    (1, 2, 64, 64, 32, True, False),
    (1, 2, 65, 65, 64, True, False),
    (1, 2, 127, 127, 128, True, True),
    (1, 2, 129, 129, 128, True, False),
    (1, 3, 70, 333, 128, True, False),    # Sq < Sk
    (1, 3, 333, 70, 16, True, False),     # Sq > Sk: fully masked rows
    (2, 2, 96, 96, 32, False, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", F32_CASES)
def test_f32_forward_kernel_matches_plain_and_feeds_the_backward(card, case):
    """``attention_f32``'s forward: O within 1e-5 of the sum of the
    absolute terms of ``attention_fwd_plain`` (3xTF32 carries each product
    to about 2^-21); two calls bit-equal; one launch a call and none of
    the scalar forward. Its stats feed the float32 backward: O and the
    grads through ``Attention`` within 1e-5 of the terms of the autograd
    of ``sdpa_plain``."""
    from deeplearning4j_tpu_torch.kernels import attention as at
    from deeplearning4j_tpu_torch.kernels import attention_f32 as af
    b, h, sq, sk, d, causal, split = case
    q, k, v, do = _attn_inputs(card, b, h, sq, sk, d, torch.float32,
                               split=split)
    before = (af.LAUNCHES["attention_fwd_f32"], at.LAUNCHES["attention_fwd"])
    o, st = at.attention_fwd(q, k, v, causal)
    o2, st2 = at.attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert (af.LAUNCHES["attention_fwd_f32"] - before[0],
            at.LAUNCHES["attention_fwd"] - before[1]) == (2, 0)
    assert torch.equal(o, o2) and torch.equal(st, st2)
    terms = at.abs_terms(q, k, v, do, causal)
    po, _ = at.attention_fwd_plain(q, k, v, causal)
    assert bool(((o.double() - po.double()).abs()
                 <= 1e-5 * terms[0] + 1e-300).all())
    got = _attn_grads(at.scaled_dot_product_attention, q, k, v, do, causal)
    want = _attn_grads(at.sdpa_plain, q, k, v, do, causal)
    for x, w, t in zip(got, want, terms):
        err = (x.double() - w.double()).abs()
        assert bool((err <= 1e-5 * t + 1e-300).all()), float(
            (err / t.clamp_min(1e-300)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("hist,rows,length,bs,d", [
    (256, 512, 500, 16, 128),      # the serving prefill, padded rows
    (0, 1, 1, 1024, 128), (15, 65, 65, 1, 16), (1000, 63, 63, 160, 32),
    (256, 64, 64, 16, 64)])
def test_paged_prefill_f32_kernel_matches_plain_on_card(card, hist, rows,
                                                        length, bs, d):
    """``paged_prefill_attention`` in float32 (``attention_f32``'s kernel)
    within 1e-5 of the sum of each element's absolute terms of its plain
    version, as the server calls it and at two other work splits (items
    of 64 keys, and one item a tile); two calls bit-equal; NaN in the null
    block, the unused blocks and past the lane's last key changes
    nothing."""
    from deeplearning4j_tpu_torch.kernels import attention_f32 as af
    from deeplearning4j_tpu_torch.kernels import measure
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    args = measure.paged_prefill_case(card, hist, rows, length, 4, d, bs,
                                      torch.float32, seed=hist + bs)
    q, kc, vc, tables, lane, kmax = args
    kh = kmax.cpu().numpy()
    before = af.LAUNCHES["paged_prefill_f32"]
    got = pa.paged_prefill_attention(q, kc, vc, tables[0], kmax, kh)
    again = pa.paged_prefill_attention(q, kc, vc, tables[0], kmax, kh)
    reach = kc.shape[2] * tables.shape[1]
    splits = [measure.paged_prefill_at_chunk(q, kc, vc, tables[0], kmax, ch)
              for ch in (af.CHUNK_ALIGN, -(-reach // af.CHUNK_ALIGN)
                         * af.CHUNK_ALIGN)]
    pk, pv = measure.paged_poisoned(kc, vc, tables, lane, kmax)
    poisoned = pa.paged_prefill_attention(q, pk, pv, tables[0], kmax, kh)
    want, terms = pa.paged_attention_plain(*args), pa.abs_terms(*args)
    torch.cuda.synchronize()
    assert af.LAUNCHES["paged_prefill_f32"] - before == 3
    assert measure.paged_reading(got, want, terms, 1e-5) <= 1
    for x in splits:
        assert measure.paged_reading(x, want, terms, 1e-5) <= 1
    assert torch.equal(got, again)
    assert bool(torch.isfinite(poisoned).all()) and torch.equal(poisoned,
                                                                got)


# ----------------------------------------------------------------------
# SameDiff's fit tiers: fused windows and the scanned epoch as CUDA graphs
def _tier_net(card, k=1):
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.nn import (DenseLayer, InputType,
                                             MultiLayerNetwork,
                                             NeuralNetConfiguration,
                                             OutputLayer)
    conf = (NeuralNetConfiguration.builder().seed(7)
            .updater(Adam(learning_rate=1e-2)).list()
            .layer(DenseLayer(n_out=32, activation="relu"))
            .layer(OutputLayer(n_out=4, loss_function="MCXENT"))
            .set_input_type(InputType.feed_forward(12)).build())
    net = MultiLayerNetwork(conf).init(card)
    net.samediff.training_config.fused_steps = k
    return net


def _tier_data(card, steps, batch=8):
    from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
    rng = np.random.default_rng(3)
    x = rng.normal(size=(steps * batch, 12)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, steps * batch)]
    return DeviceCachedIterator(x, y, batch, device=card)


def _quiet():
    from deeplearning4j_tpu_torch.autodiff import ScoreIterationListener
    return ScoreIterationListener(10 ** 9, print_fn=lambda *a: None)


def _same_params(a, b):
    for n, x in b.params().items():
        np.testing.assert_allclose(a.params()[n], x, rtol=1e-5, atol=1e-6,
                                   err_msg=n)


@pytest.mark.cuda
def test_windows_capture_once_per_length_and_replay_on_card(card):
    """K = 4 over 11 steps: windows 4, 4, 2, 1, three graphs (one a
    length), four replays an epoch, none captured in a later fit; the
    result within the tier tolerance of the per-step tier's."""
    it = _tier_data(card, 11)
    ref = _tier_net(card)
    ref.fit(it, epochs=2, listeners=[_quiet()])
    net = _tier_net(card, 4)
    net.fit(it, epochs=2, listeners=[_quiet()])
    sd = net.samediff
    assert len(sd._windows) == 3
    assert all(w.graph is not None for w in sd._windows.values())
    st = sd.last_fit_stats
    assert st["graph_replays_per_epoch"] == 4 and st["window_captures"] == 0
    assert st["window_sizes"] == {4: 2, 2: 1, 1: 1}
    net.fit(it, epochs=1)
    assert sd.last_fit_stats["window_captures"] == 0 and \
        len(sd._windows) == 3
    ref.fit(it, epochs=1, listeners=[_quiet()])
    _same_params(net, ref)


@pytest.mark.cuda
def test_scanned_epoch_is_one_replay_on_card(card):
    it = _tier_data(card, 16)
    ref, net = _tier_net(card), _tier_net(card)
    ref.fit(it, epochs=3, listeners=[_quiet()])
    hist = net.fit(it, epochs=3)
    st = net.samediff.last_fit_stats
    assert st["tier"] == "scanned_epoch"
    assert st["graph_replays_per_epoch"] == 1 and st["window_sizes"] == {
        16: 1}
    assert len(hist.step_losses) == 48
    _same_params(net, ref)


@pytest.mark.cuda
def test_a_graph_the_collector_frees_cannot_break_a_capture(card,
                                                            monkeypatch):
    """An old network's captured graph becomes cyclic garbage in the middle
    of another network's capture, with the collector set to run at every
    allocation: the capture holds (no automatic collection runs during
    it), and the old graph is freed after it."""
    import gc
    import weakref
    from deeplearning4j_tpu_torch.autodiff import window
    old = _tier_net(card)
    old.fit(_tier_data(card, 2))                # scanned: a captured graph
    gone = weakref.ref(next(iter(old.samediff._windows.values())))
    holder = [old]
    del old
    real_step = window.StepWindow._step
    seen = []

    def step(self, i):
        if torch.cuda.is_current_stream_capturing() and holder:
            holder.clear()                      # the old net: garbage now
            junk = [[object()] for _ in range(1000)]   # allocations
            seen.append((gc.isenabled(), len(junk)))
        real_step(self, i)

    monkeypatch.setattr(window.StepWindow, "_step", step)
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        net = _tier_net(card)
        net.fit(_tier_data(card, 4))
    finally:
        gc.set_threshold(*thresholds)
    assert seen and seen[0][0] is False
    assert net.samediff.last_fit_stats["graph_replays_per_epoch"] == 1
    gc.collect()
    assert gone() is None


@pytest.mark.cuda
def test_a_capture_error_propagates_on_card(card, monkeypatch):
    """An op that waits on the device cannot be captured: the graph tiers
    raise, and nothing runs the steps eagerly instead; the per-step tier
    runs it."""
    from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
    from deeplearning4j_tpu_torch.learning import Sgd
    from deeplearning4j_tpu_torch.ops import registry
    registry.op_names()
    monkeypatch.setitem(registry._REGISTRY, "test_sync", registry.Op(
        "test_sync", lambda a: a * float(a.abs().sum().item() > -1), "nn",
        1))
    sd = SameDiff(device=card)
    h = sd.invoke("test_sync", [sd.placeholder("x", shape=(-1, 12))])
    w = sd.var("w", value=np.full((12, 4), 0.1, np.float32))
    sd.loss.softmax_cross_entropy(h.mmul(w), sd.placeholder(
        "labels", shape=(-1, 4)), name="loss")
    it = _tier_data(card, 4)
    for k in (1, 2):
        sd.training_config = TrainingConfig(
            updater=Sgd(0.1), data_set_feature_mapping=["x"],
            data_set_label_mapping=["labels"], fused_steps=k)
        before = sd.get_arr_for_var("w").clone()
        with pytest.raises(RuntimeError):
            sd.fit(it)
        torch.cuda.synchronize()
        assert torch.equal(sd.get_arr_for_var("w"), before)
        assert not sd._windows
    sd.training_config.fused_steps = 1
    sd.fit(it, listeners=[_quiet()])
    assert sd.last_fit_stats["tier"] == "per_step"


@pytest.mark.cuda
def test_gpt_tiny_scanned_epoch_on_card_matches_per_step(card):
    """GPT_TINY (float32: the attention kernels) captured as one scanned
    epoch against the per-step tier: every parameter and loss."""
    from deeplearning4j_tpu_torch.autodiff import TrainingConfig
    from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.zoo import GPT_TINY, build_gpt
    rng = np.random.default_rng(0)
    ids, tgt = (rng.integers(0, GPT_TINY.vocab_size, (12, 32)).astype(
        np.int32) for _ in range(2))
    it = DeviceCachedIterator([ids], [tgt], batch_size=4, device=card)
    out = []
    for listeners in ([_quiet()], []):
        sd = build_gpt(GPT_TINY, batch=4, seq_len=32, device=card)
        sd.training_config = TrainingConfig(
            updater=Adam(1e-3), data_set_feature_mapping=["input_ids"],
            data_set_label_mapping=["targets"])
        hist = sd.fit(it, epochs=2, listeners=listeners)
        out.append((sd, hist))
    (ref, href), (sd, hist) = out
    assert sd.last_fit_stats["graph_replays_per_epoch"] == 1
    for n, x in ref.trainable_params().items():
        np.testing.assert_allclose(sd.get_arr_for_var(n).cpu().numpy(),
                                   x.cpu().numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=n)
    np.testing.assert_allclose(hist.step_losses, href.step_losses,
                               rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------------
# ComputationGraph on the fit tiers: ResNet-50 at 32x32, float32
def _resnet_tiny(card, weights=None):
    from deeplearning4j_tpu_torch.zoo import ResNet50
    net = ResNet50(height=32, width=32, num_classes=4).build(card)
    if weights is not None:
        net.model.load_state_dict(weights)
    return net


def _resnet_data(card, steps=3, batch=8):
    from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
    rng = np.random.default_rng(11)
    x = rng.normal(size=(steps * batch, 3, 32, 32)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, steps * batch)]
    return DeviceCachedIterator(x, y, batch, device=card)


@pytest.mark.cuda
def test_resnet_scanned_epoch_on_card_matches_per_step(card):
    """The scanned epoch (one replay an epoch, the BN kernels inside it:
    33 + 20 launches of each phase a step) against the per-step tier
    from the same weights, two epochs of 3 steps: every parameter, every
    running statistic and every step's loss, within the tier
    tolerance."""
    it = _resnet_data(card)
    ref = _resnet_tiny(card)
    weights = {k: v.clone() for k, v in ref.model.state_dict().items()}
    hist_ref = ref.fit(it, epochs=2, listeners=[_quiet()])
    assert ref.last_fit_stats["tier"] == "per_step"
    net = _resnet_tiny(card, weights)
    net.fit(it, epochs=1)
    bn_relu.reset_launches()
    hist = net.fit(it, epochs=1)
    st = net.last_fit_stats
    assert st["tier"] == "scanned_epoch" and st["window_captures"] == 0
    assert st["graph_replays_per_epoch"] == 1
    assert bn_relu.LAUNCHES == {
        bn_relu.kernel_name(p, r): (33 if r else 20) * 3
        for p in (1, 2) for r in (True, False)}
    _same_params(net, ref)
    np.testing.assert_allclose(hist.step_losses, hist_ref.step_losses[3:],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_two_resnet_scanned_runs_are_bit_equal_on_card(card, monkeypatch):
    """Two scanned fits from one start, cuDNN deterministic: the same
    bits in every parameter, running statistic and loss."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    it = _resnet_data(card)
    first = _resnet_tiny(card)
    weights = {k: v.clone() for k, v in first.model.state_dict().items()}
    runs = []
    for net in (first, _resnet_tiny(card, weights)):
        hist = net.fit(it, epochs=2)
        runs.append((net.params(), hist.step_losses))
    (pa, la), (pb, lb) = runs
    assert la == lb
    for k, v in pa.items():
        np.testing.assert_array_equal(pb[k], v, err_msg=k)


@pytest.mark.cuda
def test_a_replay_leaves_the_bn_scratch_where_it_was(card):
    """The warm-up steps grow the BN phase-1 scratch before the capture;
    replays (and a fit that captures nothing new) neither grow nor move
    it."""
    net = _resnet_tiny(card)
    it = _resnet_data(card)
    net.fit(it, epochs=1)
    ws, cnt = bn_relu._SCRATCH[card.index or 0]
    retired = len(bn_relu._RETIRED)
    net.fit(it, epochs=2)
    assert net.last_fit_stats["window_captures"] == 0
    torch.cuda.synchronize()
    ws2, cnt2 = bn_relu._SCRATCH[card.index or 0]
    assert (ws2.data_ptr(), cnt2.data_ptr()) == (ws.data_ptr(),
                                                 cnt.data_ptr())
    assert len(bn_relu._RETIRED) == retired


# ----------------------------------------------------------------------
# speculative int8-weight serving: int8_matmul and paged_verify_attention
@pytest.mark.cuda
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("m,k,n", [(1, 1536, 4608), (8, 6144, 1536),
                                   (64, 1536, 1536), (77, 64, 200),
                                   (9, 1552, 4624), (65, 1536, 32768),
                                   (17, 100, 72), (33, 33, 17)])
def test_int8_matmul_matches_plain_and_its_rows_ignore_m(card, m, k, n,
                                                         transposed):
    """``int8_matmul`` within 1e-5 of the sum of its absolute terms of the
    float64 plain version, two calls bit-equal, and each row's bits those
    of the same row at M = 1."""
    from deeplearning4j_tpu_torch.kernels import int8_matmul as im
    from deeplearning4j_tpu_torch.kernels import measure
    x, w, s = measure.int8_matmul_case(card, m, k, n, transposed, seed=m)
    before = im.LAUNCHES["int8_matmul"]
    got = im.int8_matmul(x, w, s, transposed)
    again = im.int8_matmul(x, w, s, transposed)
    want = im.int8_matmul_plain(x.double(), w, s.double(), transposed)
    terms = im.abs_terms(x, w, s, transposed)
    assert measure.paged_reading(got, want, terms, 1e-5) <= 1
    assert torch.equal(got, again)
    assert im.LAUNCHES["int8_matmul"] - before == 2
    for r in (0, m - 1):
        assert torch.equal(im.int8_matmul(x[r:r + 1], w, s, transposed),
                           got[r:r + 1])


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("w,d", [(2, 128), (8, 128), (20, 64), (5, 16),
                                 (1, 128), (9, 128), (16, 32)])
def test_paged_verify_kernel_matches_plain_and_decode_on_card(card, w, d,
                                                              dense):
    """``paged_verify_attention`` against ``paged_verify_plain`` (1e-5 of
    the largest magnitude), its written cache bit-equal, and each row
    bit-equal to ``paged_decode_attention`` over the written cache."""
    from deeplearning4j_tpu_torch.kernels import measure
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    case = measure.paged_verify_case(
        card, [0, 15, 40, 300], w, 3, d, 512 if dense else 16,
        torch.float32, active=[True, True, False, True], dense=dense, seed=w)
    q, kn, vn, kc, vc, tab, lane, kmax, win0, wrow, wb, wo = case
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    before = pa.LAUNCHES["paged_verify_attention"]
    got = pa.paged_verify_attention(q, kn, vn, k1, v1, tab, lane, kmax,
                                    win0, wrow, wb, wo)
    want = pa.paged_verify_plain(q, kn, vn, k2, v2, tab, lane, kmax, win0,
                                 wrow, wb, wo)
    _close(got, want, 1e-5)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    assert pa.LAUNCHES["paged_verify_attention"] - before == 1
    dec = pa.paged_decode_attention(q, kn, vn, k1.clone(), v1.clone(), tab,
                                    lane, kmax, wb, wo)
    assert torch.equal(dec, got)


@pytest.mark.cuda
def test_paged_verify_kernel_refuses_a_window_past_the_rows(card):
    """Rows whose window runs past the launch's rows, or starts before
    them, are refused on the card as the plain version refuses them: NaN
    output, the writes still made, the other rows bit-equal to a launch
    without them."""
    from deeplearning4j_tpu_torch.kernels import measure
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    bad = list(measure.paged_verify_case(card, [0, 15, 40, 3], 6, 2, 16, 16,
                                         torch.float32, seed=4))
    n = bad[0].shape[0]
    ref = [t.clone() for t in bad]
    bad[9][6:9] = torch.tensor([n, n - 1, n - 2])  # the last row past n - 1
    bad[9][9:12] = -1
    cpu = [t.cpu().clone() for t in bad]
    got = pa.paged_verify_attention(*bad)
    want = pa.paged_verify_attention(*ref)
    assert torch.isnan(got[6:12]).all()
    assert torch.equal(got[:6], want[:6]) and torch.equal(got[12:], want[12:])
    assert torch.equal(bad[3], ref[3]) and torch.equal(bad[4], ref[4])
    plain = pa.paged_verify_plain(*cpu)
    assert torch.isnan(plain[6:12]).all()
    _close(got[:6], plain[:6].to(card), 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_int8_speculative_serving_on_card_matches_cpu(card, paged):
    """GPT_TINY int8 target with an independent int8 draft, on the card and
    on the CPU: the same tokens; rounds ran through the verify kernel."""
    import dataclasses
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    from deeplearning4j_tpu_torch.serving import GenerativeServer
    from deeplearning4j_tpu_torch.serving.paged import PagedGenerativeServer
    from deeplearning4j_tpu_torch.zoo import (GPT_TINY, build_gpt,
                                              gpt_generative_spec,
                                              gpt_paged_spec)
    dcfg = dataclasses.replace(GPT_TINY, hidden_size=32, num_layers=1,
                               num_heads=2, intermediate_size=64)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (5, 17, 30)]
    out = {}
    for dev in (card, torch.device("cpu")):
        sd = build_gpt(GPT_TINY, batch=2, seq_len=8, device=dev)
        dsd = build_gpt(dcfg, batch=2, seq_len=8, seed=1, device=dev)
        draft = gpt_generative_spec(dsd, dcfg, quantize_weights=True)
        kw = dict(max_slots=2, device=dev, draft_spec=draft, speculate_k=4)
        srv = PagedGenerativeServer(
            gpt_paged_spec(sd, GPT_TINY, quantize_weights=True),
            block_size=8, debug_leaks=True, **kw) if paged else \
            GenerativeServer(gpt_generative_spec(
                sd, GPT_TINY, quantize_weights=True), **kw)
        before = pa.LAUNCHES["paged_verify_attention"]
        with srv:
            out[dev.type] = [srv.generate(p, max_new_tokens=12)
                             for p in prompts]
        launched = pa.LAUNCHES["paged_verify_attention"] - before
        if dev.type == "cuda":
            assert launched >= GPT_TINY.num_layers
            assert srv.metrics.counters["spec_rounds"] >= 1
    assert out["cuda"] == out["cpu"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_backward_is_bit_equal_over_calls(card, dtype):
    """``gather``'s backward at BERT-base's word table (30522 x 768) and
    batch (16 x 128 ids, one id 40 times): a sorted scatter, so two calls
    give the same bits; float32 within 1e-5 of a float64 sum."""
    from deeplearning4j_tpu_torch.ops.shape_ops import gather
    rng = np.random.default_rng(4)
    ids = torch.as_tensor(rng.integers(0, 30522, (16, 128)),
                          dtype=torch.int32, device=card)
    ids[0, :40] = 7
    table = torch.as_tensor(rng.normal(size=(30522, 768)),
                            device=card).to(dtype)
    g = torch.as_tensor(rng.normal(size=(16, 128, 768)), device=card).to(dtype)
    grads = []
    for _ in range(2):
        t = table.detach().requires_grad_(True)
        (gt,) = torch.autograd.grad(gather(t, ids, 0), [t], g)
        grads.append(gt)
    assert torch.equal(grads[0], grads[1])
    if dtype == torch.float32:
        want = torch.zeros(30522, 768, dtype=torch.float64, device=card)
        want.index_add_(0, ids.reshape(-1).long(),
                        g.reshape(-1, 768).double())
        _close(grads[0], want, 1e-5)


@pytest.mark.cuda
def test_gather_and_one_hot_keep_jax_answers_out_of_range_on_card(card):
    """No device assert: an index out of range fills (gather) or gives a
    zero row (one_hot), as on the CPU."""
    from deeplearning4j_tpu_torch.ops.shape_ops import gather, one_hot
    x = torch.arange(12.0).reshape(4, 3)
    ids = torch.tensor([[3, -1, 4], [-5, 0, 100]], dtype=torch.int32)
    want_g, want_o = gather(x, ids, 0), one_hot(ids, 4)
    got_g, got_o = gather(x.to(card), ids.to(card), 0), one_hot(ids.to(card),
                                                               4)
    torch.cuda.synchronize()
    assert torch.equal(got_g.isnan().cpu(), want_g.isnan())
    assert torch.equal(got_g.nan_to_num().cpu(), want_g.nan_to_num())
    assert torch.equal(got_o.cpu(), want_o)


@pytest.mark.cuda
def test_bert_tiny_step_captures_and_matches_the_per_step_tier(card):
    """BERT_TINY imported on the card, bf16 MixedPrecision: the scanned
    epoch is one captured CUDA graph (the imported ops make no host sync)
    and its losses and parameters equal the per-step tier's bit for bit
    over two epochs."""
    from deeplearning4j_tpu_torch.autodiff import (MixedPrecision,
                                                   TrainingConfig)
    from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.zoo import BERT_TINY, bert_base
    rng = np.random.default_rng(5)
    n, b, s = 24, 4, 16
    ids = rng.integers(0, BERT_TINY.vocab_size, (n, s)).astype(np.int32)
    mask = np.ones((n, s), np.int32)
    mask[::3, s // 2:] = 0
    tt = np.zeros((n, s), np.int32)
    tt[:, 5:] = 1
    labels = np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)]
    res = {}
    for tier in ("scanned", "per_step"):
        sd = bert_base(BERT_TINY, batch=b, seq_len=s, num_labels=2, seed=7,
                       device=card)
        assert sd.get_arr_for_var("classifier/kernel").is_cuda
        sd.training_config = TrainingConfig(
            updater=Adam(1e-3),
            data_set_feature_mapping=["input_ids", "input_mask",
                                      "token_type_ids"],
            data_set_label_mapping=["labels"],
            mixed_precision=MixedPrecision())
        it = DeviceCachedIterator([ids, mask, tt], [labels], b, device=card)
        h = sd.fit(it if tier == "scanned" else list(it), epochs=2)
        st = sd.last_fit_stats
        if tier == "scanned":
            assert st["tier"] == "scanned_epoch"
            assert st["graph_replays_per_epoch"] == 1
            assert len(sd._windows) == 1
        res[tier] = (h.step_losses, sd.trainable_params())
    (la, pa), (lb, pb) = res["scanned"], res["per_step"]
    assert la == lb and all(np.isfinite(la))
    for name in pa:
        assert torch.equal(pa[name], pb[name]), name


def _int8_kv_case(card, kind, dtype):
    """A float case of ``kind`` made int8 (per-(head, channel) absmax
    scales): (kernel call, plain call) over copies of the int8 cache, each
    returning (out, kc8, vc8)."""
    from deeplearning4j_tpu_torch.kernels import measure
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    if kind == "decode":
        case = measure.paged_decode_write_case(
            card, [0, 63, 511, 1015, 40], 4, 128, 16, dtype,
            active=[True, True, True, True, False], seed=3)
    elif kind == "verify":
        case = measure.paged_verify_case(card, [0, 15, 500], 8, 4, 64, 16,
                                         dtype, seed=4)
    else:
        case = measure.paged_prefill_case(card, 15, 65, 60, 4, 128, 16,
                                          dtype, seed=5)
    if kind == "prefill":
        q, kc, vc, tables, lane, kmax = case
    else:
        q, kn, vn, kc, vc, tables, lane, kmax = case[:8]
    kc8, vc8, ks, vs = measure.int8_cache(kc, vc)

    def call(plain):
        k2, v2 = kc8.clone(), vc8.clone()
        if kind == "decode":
            fn = pa.paged_decode_plain if plain else pa.paged_decode_attention
            out = fn(q, kn, vn, k2, v2, tables, lane, kmax, *case[8:], ks,
                     vs)
        elif kind == "verify":
            fn = pa.paged_verify_plain if plain else pa.paged_verify_attention
            out = fn(q, kn, vn, k2, v2, tables, lane, kmax, *case[8:], ks,
                     vs)
        elif plain:
            out = pa.paged_prefill_plain(q, k2, v2, tables[0], kmax, ks, vs)
        else:
            out = pa.paged_prefill_attention(q, k2, v2, tables[0], kmax,
                                             kmax.cpu().numpy(), ks, vs)
        return out, k2, v2
    return call


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["decode", "verify", "prefill"])
def test_int8_kv_kernels_match_plain_on_card(card, kind, dtype):
    """Each kernel over an int8 cache (decode, verify, paged prefill)
    against its plain version: the output to 1e-5 (float32) or 1e-12
    (float64) of its largest magnitude, the int8 rows it wrote bit-equal,
    each launch counted as an int8 one."""
    from deeplearning4j_tpu_torch.kernels import attention_f32 as af
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    call = _int8_kv_case(card, kind, dtype)
    before = sum(pa.INT8_LAUNCHES.values()) + af.INT8_LAUNCHES[
        "paged_prefill_f32"]
    got, gk, gv = call(False)
    want, wk, wv = call(True)
    _close(got, want, 1e-5 if dtype == torch.float32 else 1e-12)
    assert torch.equal(gk, wk) and torch.equal(gv, wv)
    assert sum(pa.INT8_LAUNCHES.values()) + af.INT8_LAUNCHES[
        "paged_prefill_f32"] - before == 1


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["decode", "verify"])
def test_int8_kv_write_is_bit_equal_across_launches(card, kind):
    """Two launches over copies of one int8 cache write the same int8 rows
    and give the same output bits."""
    call = _int8_kv_case(card, kind, torch.float32)
    a, ak, av = call(False)
    b, bk, bv = call(False)
    assert torch.equal(a, b) and torch.equal(ak, bk) and torch.equal(av, bv)


#: phase 22's cases for the int8 decode (blocks, head dim, dtype) and the
#: int8 paged prefill (hist, rows, real rows, head dim)
INT8_DECODE_CASES = [(bs, d, dt) for bs, d in ((1, 16), (5, 32), (16, 64),
                                                (1024, 128), (16, 128))
                     for dt in (torch.float32, torch.float64)]
INT8_PREFILL_CASES = [(256, 512, 512, 128), (0, 1, 1, 128), (15, 63, 60, 128),
                      (1000, 65, 20, 128), (15, 65, 65, 16), (256, 64, 64, 64),
                      (0, 512, 512, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("bs,d,dtype", INT8_DECODE_CASES)
def test_int8_decode_kernel_at_phase_22_shapes(card, bs, d, dtype):
    """The int8 decode (a ring of one slot, as over a float cache; in
    float32 s_k folded into q and s_v into the combine) against its plain
    version within 1e-5 / 1e-12
    of the sum of each output's absolute terms, the written int8 rows
    bit-equal to the plain store, two calls bit-equal; the verify's rows
    over the same keys bit-equal to it."""
    from deeplearning4j_tpu_torch.kernels import measure
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    case = measure.paged_decode_write_case(
        card, [0, 15, 16, 300, 999, 1015, 40, 511], 3, d, bs, dtype,
        active=[True] * 7 + [False], seed=bs + d)
    q, kn, vn, kc, vc, tables, lane, kmax, wb, wo = case
    kc8, vc8, ks, vs = measure.int8_cache(kc, vc)

    def run(fn):
        k2, v2 = kc8.clone(), vc8.clone()
        return fn(q, kn, vn, k2, v2, tables, lane, kmax, wb, wo, ks,
                  vs), k2, v2
    got, gk, gv = run(pa.paged_decode_attention)
    again, ak, av = run(pa.paged_decode_attention)
    want, wk, wv = run(pa.paged_decode_plain)
    terms = pa.abs_terms(q, wk, wv, tables, lane, kmax, ks, vs)
    assert measure.paged_reading(got, want, terms, tol) <= 1
    assert torch.equal(gk, wk) and torch.equal(gv, wv)
    assert torch.equal(got, again) and torch.equal(gk, ak)
    # a verify of window 1 at each row's last key: the decode's bits
    win0 = torch.where(wb >= 0, kmax, -1).to(torch.int32)
    wrow = torch.arange(q.shape[0], dtype=torch.int32, device=card)
    ver = pa.paged_verify_attention(q, kn, vn, kc8.clone(), vc8.clone(),
                                    tables, lane, kmax, win0, wrow, wb, wo,
                                    ks, vs)
    act = (wb >= 0).nonzero().flatten()
    assert torch.equal(ver[act], got[act])


@pytest.mark.cuda
@pytest.mark.parametrize("hist,rows,length,d", INT8_PREFILL_CASES)
def test_int8_prefill_kernel_at_phase_22_shapes(card, hist, rows, length,
                                                d):
    """The int8 paged prefill (``prefill_i8_kernel``: bf16 wgmma with q *
    s_k and P in three pieces) against its plain version within 1e-5 of
    the sum of each output's absolute terms, as the server calls it and at
    two other work splits, two calls bit-equal, one int8 launch counted a
    call."""
    from deeplearning4j_tpu_torch.kernels import attention_f32 as af
    from deeplearning4j_tpu_torch.kernels import measure
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    q, kc, vc, tables, lane, kmax = measure.paged_prefill_case(
        card, hist, rows, length, 12, d, 16, torch.float32, seed=rows + d)
    kc8, vc8, ks, vs = measure.int8_cache(kc, vc)
    want = pa.paged_prefill_plain(q, kc8, vc8, tables[0], kmax, ks, vs)
    terms = pa.abs_terms(q, kc8, vc8, tables, lane, kmax, ks, vs)
    before = af.INT8_LAUNCHES["paged_prefill_f32"]
    kh = kmax.cpu().numpy()
    got = pa.paged_prefill_attention(q, kc8, vc8, tables[0], kmax, kh, ks, vs)
    again = pa.paged_prefill_attention(q, kc8, vc8, tables[0], kmax, kh, ks,
                                       vs)
    assert af.INT8_LAUNCHES["paged_prefill_f32"] - before == 2
    assert measure.paged_reading(got, want, terms, 1e-5) <= 1
    assert torch.equal(got, again)
    for chunk in (64, 256):
        out = torch.empty_like(want)
        reach = kc8.shape[2] * tables.shape[1]
        part = torch.empty(max(af.partial_floats(12, rows, reach, chunk, d),
                               1), device=card)
        af.launch_prefill(q, kc8, vc8, tables[0], kmax, out, part,
                          1.0 / math.sqrt(d), chunk,
                          torch.cuda.current_stream().cuda_stream, ks, vs)
        assert measure.paged_reading(out, want, terms, 1e-5) <= 1, chunk


#: phase 22's shapes for the int8 verify (W, head dim, blocks of, dense)
INT8_VERIFY_CASES = [(w, d, bs, dense, dt)
                     for w, d, bs, dense in ((1, 64, 16, False),
                                             (3, 64, 16, False),
                                             (8, 128, 16, False),
                                             (20, 64, 16, False),
                                             (8, 16, 5, False),
                                             (8, 32, 1, False),
                                             (3, 128, 512, True),
                                             (20, 16, 1, False))
                     for dt in (torch.float32, torch.float64)]


@pytest.mark.cuda
@pytest.mark.parametrize("w,d,bs,dense,dtype", INT8_VERIFY_CASES)
def test_int8_verify_kernel_at_phase_22_shapes(card, w, d, bs, dense, dtype):
    """The int8 verify (float32: ``paged_verify_i8_kernel``; float64: the
    float kernel's template over int8) against ``paged_verify_plain``
    within 1e-5 / 1e-12 of the sum of each output's absolute terms, the
    int8 rows it wrote bit-equal to the plain store, two calls bit-equal,
    and each row bit-equal to the decode kernel's over the written cache."""
    from deeplearning4j_tpu_torch.kernels import measure
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    case = measure.paged_verify_case(
        card, [0, 40, 300, 500], w, 3, d, bs, dtype,
        active=[True, True, False, True], seed=w + d, dense=dense)
    q, kn, vn, kc, vc, tables, lane, kmax, win0, wrow, wb, wo = case
    kc8, vc8, ks, vs = measure.int8_cache(kc, vc)

    def run(fn):
        k2, v2 = kc8.clone(), vc8.clone()
        return fn(q, kn, vn, k2, v2, tables, lane, kmax, win0, wrow, wb, wo,
                  ks, vs), k2, v2
    before = pa.INT8_LAUNCHES["paged_verify_attention"]
    got, gk, gv = run(pa.paged_verify_attention)
    again, ak, av = run(pa.paged_verify_attention)
    assert pa.INT8_LAUNCHES["paged_verify_attention"] - before == 2
    want, wk, wv = run(pa.paged_verify_plain)
    terms = pa.abs_terms(q, wk, wv, tables, lane, kmax, ks, vs)
    assert measure.paged_reading(got, want, terms, tol) <= 1
    assert torch.equal(gk, wk) and torch.equal(gv, wv)
    assert torch.equal(got, again) and torch.equal(gk, ak) and \
        torch.equal(gv, av)
    act = (wb >= 0).nonzero().flatten()
    dec = pa.paged_decode_attention(q, kn, vn, gk.clone(), gv.clone(), tables,
                                    lane, kmax, wb, wo, ks, vs)
    assert torch.equal(dec[act], got[act])


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype,int8", [
    (128, torch.float32, False), (128, torch.float32, True),
    (64, torch.float64, True), (16, torch.float64, False)])
def test_occupancy_entries_report_resident_blocks(card, d, dtype, int8):
    """The decode kernel's occupancy entry gives at least one resident
    block an SM and one cluster of 8 on the card for each cache type, and
    the float32 attention's entry at least one block an SM for each of its
    kinds."""
    from deeplearning4j_tpu_torch.kernels import attention_f32 as af
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    blocks, clusters = pa.decode_occupancy(d, dtype, int8)
    assert blocks >= 1 and clusters >= 1
    for kind in af.KINDS:
        assert af.blocks_per_sm(d, kind) >= 1


def _served_resnet(card):
    """ResNet-50 at 32x32, 10 classes, on the card, its batch norms'
    running statistics set from one seeded batch (so that outputs depend
    on the input), and seeded requests of 1-3 images."""
    from deeplearning4j_tpu_torch.kernels.measure import set_running_stats
    from deeplearning4j_tpu_torch.zoo import ResNet50
    net = ResNet50(height=32, width=32, num_classes=10).build()
    assert next(net.model.parameters()).device.type == "cuda"
    rng = np.random.default_rng(3)
    set_running_stats(net, rng.uniform(size=(16, 3, 32, 32)))
    xs = [rng.uniform(size=(int(rng.integers(1, 4)), 3, 32, 32))
          .astype(np.float32) for _ in range(8)]
    return net, xs


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["BATCHED", "INPLACE"])
def test_parallel_inference_on_card_matches_output(card, mode):
    """Served on the card (the network's device, no ``device=``), each
    request's rows within 1e-5 of ``output()`` (softmax probabilities,
    TF32 off: the same float32 arithmetic, but a bucket may take another
    cuDNN kernel than the request's own row count); in BATCHED mode a
    request co-batched at its bucket gives its solo rows bit for bit."""
    from deeplearning4j_tpu_torch.serving import (InferenceMode,
                                                  ParallelInference)
    net, xs = _served_resnet(card)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with ParallelInference(net, mode=getattr(InferenceMode, mode),
                               max_batch_size=8, buckets=(8,),
                               max_delay_ms=200.0,
                               warmup_buckets=True) as pi:
            assert pi.device.type == "cuda"
            futs = [pi.submit(x) for x in xs]
            got = [f.result(timeout=120) for f in futs]
            solo = [pi.output(x) for x in xs] if mode == "BATCHED" else got
            assert pi.metrics.counters["compiles"] == (
                0 if mode == "BATCHED" else len({len(x) for x in xs} - {
                    1, 2, 4, 8}))
        for x, g, s in zip(xs, got, solo):
            want = net.output(x)[0].cpu().numpy()
            assert g.shape == want.shape
            np.testing.assert_allclose(g, want, rtol=0, atol=1e-5)
            assert np.array_equal(g, s)
        assert np.abs(got[0][0] - got[1][0]).max() > 1e-3
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


# ----------------------------------------------------------------------
# the training options and rails on the card (autodiff/step.py,
# checkpoint/, faults/)
class _StepSource:
    """Batches keyed by the model's absolute iteration: a pass runs from
    ``iteration_count`` to the end of the epoch (a retry after a rollback
    resumes where the checkpoint stopped)."""

    def __init__(self, batches, tc):
        self.batches, self.tc = batches, tc

    def __iter__(self):
        n = len(self.batches)
        for i in range(self.tc.iteration_count % n, n):
            yield self.batches[i]


def _options_net(card, accum=2):
    from deeplearning4j_tpu_torch.learning import (L2Regularization,
                                                   Nesterovs, RampSchedule,
                                                   StepSchedule)
    net = _tier_net(card, 4)
    tc = net.samediff.training_config
    tc.updater = Nesterovs(learning_rate=RampSchedule(
        base=StepSchedule(initial_value=0.1, decay_rate=0.1, step=8),
        num_iter=4), momentum=0.9)
    tc.regularization = [L2Regularization(l2=1e-4)]
    tc.accum_steps, tc.sentinel = accum, True
    return net


def _device_batches(card, steps, batch=8):
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(size=(steps * batch, 12)),
                        dtype=torch.float32, device=card)
    y = torch.as_tensor(np.eye(4)[rng.integers(0, 4, steps * batch)],
                        dtype=torch.float32, device=card)
    return [(x[i:i + batch], y[i:i + batch])
            for i in range(0, len(x), batch)]


@pytest.mark.cuda
def test_a_rollback_captures_no_window_and_heals_bit_equal_on_card(
        card, tmp_path):
    """Windows of 4, accum 2, the sentinel, checkpoints every 8 over 24
    device batches: a batch poisoned at 13 rolls the run back to 8 with
    no window captured again, and it ends bit-equal to the clean run."""
    from deeplearning4j_tpu_torch.checkpoint import (CheckpointListener,
                                                     CheckpointManager)
    from deeplearning4j_tpu_torch.faults import (ChaosMonkey,
                                                 FaultTolerantFit,
                                                 RetryPolicy)
    batches = _device_batches(card, 24)
    a = _options_net(card)
    a.fit(_StepSource(batches, a.samediff.training_config),
          listeners=[CheckpointListener(CheckpointManager(tmp_path / "a"),
                                        every_n_iterations=8)])
    b = _options_net(card)
    sd = b.samediff
    init = b.capture_training_state()            # before any step
    sd.fit(_StepSource(batches[:4], sd.training_config),
           listeners=[_quiet()])                  # captures the window
    b.restore_training_state(init)
    captured = sd.captures_total
    mgr = CheckpointManager(tmp_path / "b")
    it = ChaosMonkey(seed=0).poison_batches(
        _StepSource(batches, sd.training_config), at_step=13)
    ftf = FaultTolerantFit(b, mgr, policy=RetryPolicy(backoff_base=0.0),
                           checkpoint_every_n_iterations=8,
                           sleep=lambda s: None)
    ftf.fit(it, epochs=1)
    assert [e["event"] for e in ftf.events] == [
        "fault", "rollback", "retry", "recovered"]
    assert ftf.events[0]["step"] == 13
    assert sd.captures_total == captured
    for n, x in a.params().items():
        assert np.array_equal(b.params()[n], x), n


@pytest.mark.cuda
def test_the_sentinel_reads_one_bad_element_of_a_large_leaf_on_card(card):
    from deeplearning4j_tpu_torch.autodiff.step import sentinel_ok
    g = [torch.ones(3_000_001, device=card), torch.zeros(7, 5, device=card)]
    g[0][1_234_567] = 3e38                    # a sum of squares overflows
    assert bool(sentinel_ok(torch.tensor(1.0, device=card), g))
    for bad in (float("nan"), float("inf"), -float("inf")):
        g[0][2_999_999] = bad
        assert not bool(sentinel_ok(torch.tensor(1.0, device=card), g))
        g[0][2_999_999] = 1.0


@pytest.mark.cuda
def test_divergence_inside_a_captured_window_names_its_step_on_card(card):
    from deeplearning4j_tpu_torch.faults import (ChaosMonkey,
                                                 TrainingDivergedError)
    for accum in (1, 2):
        net = _options_net(card, accum)
        it = _tier_data(card, 8)
        with ChaosMonkey().nan_gradients(net, at_step=5):
            with pytest.raises(TrainingDivergedError) as ei:
                net.fit(it)
        assert ei.value.step == 5 and ei.value.batch_index == 5
        assert all(w.graph is not None
                   for w in net.samediff._windows.values())


@pytest.mark.cuda
def test_accumulation_captures_one_window_a_phase_on_card(card):
    """K = 3 and accum 2: windows start at both phases, two graphs; a
    later fit captures none, and the result meets the tier rule against
    the per-step tier (K = 1, the same accumulation)."""
    net = _options_net(card)
    net.samediff.training_config.fused_steps = 3
    it = _tier_data(card, 12)
    net.fit(it, epochs=1, listeners=[_quiet()])
    sd = net.samediff
    assert sd.last_fit_stats["window_captures"] == 2
    net.fit(it, epochs=1, listeners=[_quiet()])
    assert sd.last_fit_stats["window_captures"] == 0
    ref = _options_net(card)
    ref.samediff.training_config.fused_steps = 1
    ref.fit(it, epochs=2, listeners=[_quiet()])
    _same_params(net, ref)


@pytest.mark.cuda
def test_a_checkpoint_capture_is_a_copy_on_card(card):
    from deeplearning4j_tpu_torch.checkpoint import (capture_training_state,
                                                     restore_training_state)
    net = _options_net(card)
    it = _tier_data(card, 8)
    net.fit(it)
    snap = capture_training_state(net)
    before = {k: v.copy() for k, v in snap.arrays.items()}
    leaves = [v.copy() for v in snap.updater_leaves]
    ptrs = [t.data_ptr() for t in net.samediff.trainable_params().values()]
    net.fit(it)                                   # replays the window
    for k, v in before.items():
        assert np.array_equal(snap.arrays[k], v), k
    restore_training_state(net, snap)
    assert [t.data_ptr() for t in
            net.samediff.trainable_params().values()] == ptrs
    for k, v in before.items():
        assert np.array_equal(net.params()[k], v), k
    assert all(np.array_equal(a, b) for a, b in zip(
        capture_training_state(net).updater_leaves, leaves))


# ----------------------------------------------------------------------
# the LSTM recurrence kernels (csrc/lstm_recurrence.cu) and TextGenLSTM's
# TBPTT tier
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b,t,u", [(32, 50, 256), (3, 1, 5), (3, 7, 37),
                                   (8, 20, 512), (64, 7, 256), (128, 5, 512),
                                   (1024, 3, 37), (8, 20, 300), (4, 3, 4096)])
@pytest.mark.parametrize("sequences", [True, False])
def test_lstm_recurrence_kernels_match_plain_on_card(card, b, t, u, dtype,
                                                     sequences):
    """Forward and backward against the plain versions on the same inputs
    (the backward from the plain forward's gates; without ``sequences``
    no d_hs and no dc_T, as ``return_sequences=False`` leaves them), one
    launch each, two calls bit-equal; the plan's shared memory is the C
    side's and its clusters fit the card (512 and 4096 units, and 300
    float64: the streamed form, 4096 past the widths whose h tiles the
    resident form could hold; 300 float32: 3 groups of 8 units a block,
    not a power of two; 64 rows and more in float32 with the slice
    resident: more clusters than the card holds at 8 rows a cluster, so
    tiles of 16 or 32)."""
    from deeplearning4j_tpu_torch.kernels import lstm
    from deeplearning4j_tpu_torch.kernels.measure import lstm_recurrence_case
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    gx, w, h0, c0, d_hs, dh_t, dc_t = lstm_recurrence_case(
        b, t, u, dtype, card, seed=b * t + u)
    if not sequences:
        d_hs = dc_t = None
    want_f = lstm.lstm_recurrence_fwd_plain(gx, w, h0, c0)
    bwd_in = (want_f[0], want_f[2], c0, w, d_hs, dh_t, dc_t)
    want_b = lstm.lstm_recurrence_bwd_plain(*bwd_in)
    before = dict(lstm.LAUNCHES)
    buf = gx.clone()
    got_f = lstm.lstm_recurrence_fwd(buf, w, h0, c0)
    got_b = lstm.lstm_recurrence_bwd(*bwd_in)
    torch.cuda.synchronize()
    assert {k: lstm.LAUNCHES[k] - before[k] for k in before} == \
        {"lstm_recurrence_fwd": 1, "lstm_recurrence_bwd": 1}
    assert got_f[0] is buf
    for got, want in zip(got_f + got_b, want_f + want_b):
        _close(got, want, tol)
    again = lstm.lstm_recurrence_fwd(gx.clone(), w, h0, c0) + \
        lstm.lstm_recurrence_bwd(*bwd_in)
    assert all(torch.equal(x, y) for x, y in zip(again, got_f + got_b))
    plan = lstm._card_plan(card.index or 0, dtype, b, u)
    q = lstm.query(u, plan.ranks, plan.n_tiles, plan.resident, dtype)
    assert q[:2] == (plan.smem_fwd, plan.smem_bwd)
    assert min(q[2:]) >= 1 and plan.max_clusters == min(q[2:])
    assert plan.resident == (u <= (384 if dtype == torch.float32 else 256))
    if b >= 64 and dtype == torch.float32 and plan.resident:
        assert plan.n_tiles > 1


@pytest.mark.cuda
def test_lstm_recurrence_replays_in_a_cuda_graph_as_eager(card):
    """TextGenLSTM's layer (32, 50, 256) float32: both kernels captured in
    a CUDA graph (the gx copy in front: the forward writes over it) replay
    to the eager call's bits."""
    from deeplearning4j_tpu_torch.kernels import lstm
    from deeplearning4j_tpu_torch.kernels.measure import lstm_recurrence_case
    gx, w, h0, c0, d_hs, dh_t, dc_t = lstm_recurrence_case(
        32, 50, 256, torch.float32, card)
    buf = torch.empty_like(gx)

    def run():
        buf.copy_(gx)
        gates, hs, cs = lstm.lstm_recurrence_fwd(buf, w, h0, c0)
        return (gates, hs, cs) + lstm.lstm_recurrence_bwd(
            gates, cs, c0, w, d_hs, dh_t, dc_t)

    eager = [t.clone() for t in run()]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run()
    for _ in range(2):
        buf.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(outs, eager))


@pytest.mark.cuda
def test_lstm_layer_float64_on_card_matches_cpu(card):
    from deeplearning4j_tpu_torch.ops import registry
    g = torch.Generator().manual_seed(1)
    shapes = ((4, 7, 5), (4, 6), (4, 6), (5, 24), (6, 24), (24,))
    ts = [torch.randn(*s, generator=g, dtype=torch.float64) for s in shapes]
    res = {}
    for d in ("cpu", card):
        xs = [t.to(d).requires_grad_(True) for t in ts]
        o = registry.get_op("lstm_layer").fn(*xs)
        loss = (o[0] ** 2).sum() + o[1].sum() + (o[2] ** 3).sum()
        res[str(d)] = [t.detach().cpu() for t in
                       list(o) + list(torch.autograd.grad(loss, xs))]
    for a, b in zip(res["cpu"], res[str(card)]):
        _close(b, a, 1e-12)


@pytest.mark.cuda
def test_fit_tbptt_captures_one_window_and_counts_its_launches_on_card(card):
    from deeplearning4j_tpu_torch.kernels import lstm
    from deeplearning4j_tpu_torch.zoo import TextGenLSTM
    net = TextGenLSTM(vocab_size=12, units=16, seed=0).build()
    rng = np.random.default_rng(0)
    eye = np.eye(12, dtype=np.float32)
    x = torch.tensor(eye[rng.integers(0, 12, (8, 20))], device=card)
    y = torch.tensor(eye[rng.integers(0, 12, (8, 20))], device=card)
    before = dict(lstm.LAUNCHES)
    h = net.fit_tbptt(x, y, 5, epochs=2, batch_size=4)
    sd, _ = net._tbptt_graphs[4]
    st = sd.last_fit_stats
    assert st["window_captures_by_epoch"] == [1, 0]
    assert st["graph_replays_per_epoch"] == 2
    # 2 epochs x 2 minibatches x 4 chunks, and the capture's 2 warm-up
    # steps: one launch a layer each way, 2 a chunk
    for k in before:
        assert lstm.LAUNCHES[k] - before[k] == (16 + 2) * 2
    assert np.isfinite(h.step_losses).all()


# ----------------------------------------------------------------------
# dropout (csrc/dropout.cu)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float64])
@pytest.mark.parametrize("n,offset", [(128 * 6400, 0), (4097, 0), (5, 1),
                                      (1003, 1)])
def test_dropout_kernel_matches_plain_bit_for_bit(card, n, offset, dtype):
    """Forward and backward against ``dropout_plain`` on the same key and
    counter, at an iteration past 2^32 too; ``offset`` 1 reads views off
    16 bytes in place."""
    from deeplearning4j_tpu_torch.kernels import dropout as dk
    g = torch.Generator(device=card).manual_seed(n)
    buf = torch.randn(2, n + 1, generator=g, device=card).to(dtype)
    x, dy = buf[0, offset:offset + n], buf[1, offset:offset + n]
    seed = torch.tensor([99], dtype=torch.int64, device=card)
    for it_v, p in ((3, 0.5), (2 ** 33 + 1, 0.8)):
        it = torch.tensor([it_v], dtype=torch.int64, device=card)
        before = dict(dk.LAUNCHES)
        xg = x.detach().requires_grad_(True)
        y = dk.dropout(xg, p, seed, it, 4)
        y.backward(dy)
        torch.cuda.synchronize()
        assert torch.equal(y, dk.dropout_plain(x, p, seed, it, 4))
        assert torch.equal(xg.grad, dk.dropout_plain(dy, p, seed, it, 4))
        assert dk.LAUNCHES["dropout_fwd"] == before["dropout_fwd"] + 1
        assert dk.LAUNCHES["dropout_bwd"] == before["dropout_bwd"] + 1


@pytest.mark.cuda
def test_dropout_in_a_cuda_graph_reads_the_staged_iteration(card):
    from deeplearning4j_tpu_torch.kernels import dropout as dk
    x = torch.randn(4096, device=card)
    seed = torch.tensor([1], dtype=torch.int64, device=card)
    it = torch.zeros(1, dtype=torch.int64, device=card)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        dk.dropout_apply(x, 0.5, seed, it, 0)
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = dk.dropout_apply(x, 0.5, seed, it, 0)
    outs = []
    for v in (0, 1, 0):
        it.fill_(v)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, dk.dropout_plain(x, 0.5, seed, v, 0))
        outs.append(y.clone())
    assert not torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0], outs[2])


@pytest.mark.cuda
def test_alexnet_sized_mlp_with_dropout_tiers_agree_on_card(card):
    """A network with dropout on the three fit tiers on the card: the same
    losses and parameters bit for bit (the masks come from the staged
    seed and iterations, each window captured once)."""
    import deeplearning4j_tpu_torch.nn as pnn
    from deeplearning4j_tpu_torch.autodiff import ScoreIterationListener
    from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
    from deeplearning4j_tpu_torch.learning import Sgd
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 96)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 64)]
    quiet = [ScoreIterationListener(10 ** 9, lambda *a: None)]
    out = {}
    for tier, kw in (("scanned", {}), ("windows", {"fused_steps": 4,
                                                   "listeners": quiet}),
                     ("per-step", {"listeners": quiet})):
        conf = (pnn.NeuralNetConfiguration.builder().seed(1)
                .updater(Sgd(0.1)).list()
                .layer(pnn.DenseLayer(n_out=128, dropout=0.5))
                .layer(pnn.DenseLayer(n_out=64, dropout=0.5))
                .layer(pnn.OutputLayer(n_out=10))
                .set_input_type(pnn.InputType.feed_forward(96)).build())
        net = pnn.MultiLayerNetwork(conf).init(device=card)
        h = net.fit(DeviceCachedIterator(x, y, 8, device=card), **kw)
        out[tier] = (h.step_losses, net.params())
    for tier in ("windows", "per-step"):
        assert out[tier][0] == out["scanned"][0]
        for k, v in out["scanned"][1].items():
            np.testing.assert_array_equal(out[tier][1][k], v, err_msg=k)


# ----------------------------------------------------------------------
# the GRU, peephole LSTM and simple RNN recurrences (the cells of
# csrc/lstm_recurrence.cu's cluster engine) and the noise draws
# (csrc/dropout.cu dl4j_noise)
RNN_CASES = [(64, 256, 256), (7, 50, 100), (1, 1, 5), (64, 12, 16),
             (5, 9, 24), (8, 20, 384), (8, 20, 512)]


def _rnn_check(card, cell, b, t, u, dtype, act=1):
    from deeplearning4j_tpu_torch.kernels import recurrence
    from deeplearning4j_tpu_torch.kernels.measure import (
        rnn_bwd_args, rnn_fwd_args, rnn_recurrence_case)
    case = rnn_recurrence_case(cell, b, t, u, dtype, card, seed=b + t + u,
                               act=act)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    before = dict(recurrence.LAUNCHES)
    got_f = recurrence.recurrence_fwd(cell, case["gx"].clone(),
                                      *rnn_fwd_args(case))
    want_b = recurrence.recurrence_bwd_plain(cell, *rnn_bwd_args(case))
    got_b = recurrence.recurrence_bwd(cell, *rnn_bwd_args(case))
    torch.cuda.synchronize()
    assert {k: recurrence.LAUNCHES[k] - before[k] for k in before
            if recurrence.LAUNCHES[k] != before[k]} == {
        f"{cell}_recurrence_fwd": 1, f"{cell}_recurrence_bwd": 1}
    for g, w in zip(got_f, (case["saved"], case["hs"], case["cs"],
                            case["hn"])):
        if w is not None:
            _close(g, w, tol)
    for g, w in zip(got_b, want_b):
        if w is not None:
            _close(g, w, tol)
    again_f = recurrence.recurrence_fwd(cell, case["gx"].clone(),
                                        *rnn_fwd_args(case))
    again_b = recurrence.recurrence_bwd(cell, *rnn_bwd_args(case))
    for x, y in zip(again_f + again_b, got_f + got_b):
        assert x is None or torch.equal(x, y)
    # both kernels captured in a CUDA graph replay to the eager bits
    buf = torch.empty_like(case["gx"])

    def step():
        buf.copy_(case["gx"])
        return recurrence.recurrence_fwd(cell, buf, *rnn_fwd_args(case)) + \
            recurrence.recurrence_bwd(cell, *rnn_bwd_args(case))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = step()
    buf.zero_()
    graph.replay()
    torch.cuda.synchronize()
    for x, y in zip(outs, got_f + got_b):
        assert x is None or torch.equal(x, y)
    # the plan's shared memory is the C side's, its clusters fit the card
    plan = recurrence._card_plan(card.index or 0, cell, dtype, b, u)
    q = recurrence.query(cell, u, plan.ranks, plan.n_tiles, plan.resident,
                         dtype)
    assert q[:2] == (plan.smem_fwd, plan.smem_bwd)
    assert min(q[2:]) >= 1 and plan.max_clusters == min(q[2:])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b,t,u", RNN_CASES)
@pytest.mark.parametrize("cell", ["gru", "graves", "simple"])
def test_rnn_recurrence_kernels_match_plain_on_card(card, cell, b, t, u,
                                                    dtype):
    """Forward and backward against the plain versions at the sentiment
    graph's and the TBPTT network's shapes, ragged widths and rows (U 5,
    24, 100), one step, the widest resident width (384) and past it (512,
    streamed but the simple RNN's); two calls, and a CUDA-graph replay,
    bit-equal."""
    _rnn_check(card, cell, b, t, u, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("act", sorted({v for v in range(7)}))
def test_simple_rnn_kernel_each_activation_on_card(card, act):
    for dtype in (torch.float32, torch.float64):
        _rnn_check(card, "simple", 7, 30, 100, dtype, act=act)


@pytest.mark.cuda
def test_rnn_recurrence_replays_in_a_cuda_graph_as_eager(card):
    from deeplearning4j_tpu_torch.kernels import recurrence
    from deeplearning4j_tpu_torch.kernels.measure import (
        rnn_bwd_args, rnn_fwd_args, rnn_recurrence_case)
    for cell in ("gru", "graves", "simple"):
        case = rnn_recurrence_case(cell, 16, 20, 64, torch.float32, card)
        buf = case["gx"].clone()

        def step():
            buf.copy_(case["gx"])
            f = recurrence.recurrence_fwd(cell, buf, *rnn_fwd_args(case))
            return f + recurrence.recurrence_bwd(cell, *rnn_bwd_args(case))
        eager = [None if x is None else x.clone() for x in step()]
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            step()
        torch.cuda.current_stream().wait_stream(s)
        with torch.cuda.graph(g):
            outs = step()
        g.replay()
        torch.cuda.synchronize()
        for x, y in zip(outs, eager):
            assert x is None or torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize("kind", ["gaussian_noise", "gaussian_dropout",
                                  "alpha_dropout", "alpha_dropout_bwd",
                                  "spatial_dropout"])
def test_noise_kernel_matches_plain_on_card(card, kind, dtype):
    """The Bernoulli kinds bit for bit; the Gaussian ones within 4 ulp of
    the output dtype of the terms' magnitude (the normals are float64
    ``log``/``cos``/``sin``, which may round a last bit apart)."""
    from deeplearning4j_tpu_torch.kernels import dropout as dk
    seed = torch.tensor([12345 + (1 << 33)], dtype=torch.int64, device=card)
    it = torch.tensor([7], dtype=torch.int64, device=card)
    for shape, axis in (((64, 256, 300), -1), ((5, 3, 7, 9), 1),
                        ((1001,), -1)):
        x = torch.randn(shape, device=card).to(dtype)
        before = dict(dk.LAUNCHES)
        name = "alpha_dropout_bwd" if kind == "alpha_dropout_bwd" \
            else f"{kind}_fwd"
        got = dk.noise_apply(kind, x, seed, it, 3, name, p=0.9, stddev=0.3,
                             channel_axis=axis)
        want = dk.noise_plain(kind, x, seed, it, 3, p=0.9, stddev=0.3,
                              channel_axis=axis)
        assert dk.LAUNCHES[name] == before[name] + 1
        if kind in ("gaussian_noise", "gaussian_dropout"):
            eps = torch.finfo(dtype).eps
            n = dk.normals_plain(x.numel(), seed, it, 3, card).reshape(shape)
            scale = (x.double().abs() * (1 + 0.3 * n.abs()) + 0.3 * n.abs()
                     + want.double().abs())
            assert bool(((got.double() - want.double()).abs()
                         <= 4 * eps * scale).all())
        else:
            assert torch.equal(got, want)
        assert torch.equal(got, dk.noise_apply(kind, x, seed, it, 3, name,
                                               p=0.9, stddev=0.3,
                                               channel_axis=axis))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_noise_kernel_float32_normals_within_the_stated_bound(card, dtype):
    """The kernel's float32 normals (x = 0, s = 1: the Gaussian noise is
    the normal itself, in float32 exactly) against ``normals_plain``'s,
    within ``NORMAL_KERNEL_REL`` (2^-20) of each magnitude; in bf16 the
    noise of x = 0 is the float32 normal rounded once."""
    from deeplearning4j_tpu_torch.kernels import dropout as dk
    seed = torch.tensor([77 + (1 << 35)], dtype=torch.int64, device=card)
    it = torch.tensor([5], dtype=torch.int64, device=card)
    x = torch.zeros(64, 256, 300, device=card, dtype=dtype)
    got = dk.noise_apply("gaussian_noise", x, seed, it, 2,
                         "gaussian_noise_fwd", stddev=1.0)
    want = dk.normals_plain(x.numel(), seed, it, 2, card,
                            torch.float32).reshape(x.shape)
    if dtype == torch.float32:
        assert bool(((got.double() - want.double()).abs()
                     <= dk.NORMAL_KERNEL_REL * want.double().abs()).all())
    else:
        eps = torch.finfo(dtype).eps
        assert bool(((got.double() - want.double()).abs()
                     <= eps * want.double().abs()).all())
