"""The port's kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and skips without a card; none imports
JAX, so the file runs on a machine that has only the port's
dependencies: ``python -m pytest tests/test_torch_card.py -m cuda``.
Tolerance: 1e-5 of the largest magnitude for float32 and 1e-12 for
float64 (the same arithmetic; only the order of the sums differs), 1e-2
for bf16 (dx is rounded to 8 bits).
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.kernels import bn_relu

EPS = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Triton kernels have no CPU mode")
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


@pytest.mark.cuda
def test_kernels_refuse_float16(card):
    x = torch.zeros(8, 4, dtype=torch.float16, device=card)
    v = torch.zeros(4, dtype=torch.float16, device=card)
    with pytest.raises(ValueError, match="does not take"):
        bn_relu.bn_bwd_phase1(x, x, v, v, v.float(), True)


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
    assert bn_relu.LAUNCHES == {"bn_relu_bwd_phase1": 33,
                                "bn_relu_bwd_phase2": 33,
                                "bn_bwd_phase1": 20, "bn_bwd_phase2": 20}
