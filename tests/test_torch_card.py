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
    bn_relu.reset_launches()
    loss = net.fit(DeviceCachedIterator(x, y, batch_size=8)).final_loss()
    assert np.isfinite(loss)
    # 53 + 53: one phase-1 and one phase-2 launch per BN backward
    assert bn_relu.LAUNCHES == {"bn_relu_bwd_phase1": 33,
                                "bn_relu_bwd_phase2": 33,
                                "bn_bwd_phase1": 20, "bn_bwd_phase2": 20}
