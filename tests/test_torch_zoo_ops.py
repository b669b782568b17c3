"""The ops of the zoo's image models against the JAX package's: each
forward and its gradient (``jax.grad`` of a seeded cotangent's dot
product) on the same seeded numpy inputs, in float32 and float64.

Ops: every activation of ``nn/activations.py`` (their ``ops/elementwise``
ops, with inputs on the clipped activations' bounds and ReLU-made zeros,
where JAX's ties take half a gradient), ``lrn``, ``deconv2d`` (SAME and
VALID, strides 1 and 2, kernels 2 and 3), ``depthwise_conv2d``
(multipliers 1 and 2), ``separable_conv2d``, ``space_to_depth`` and
``depth_to_space`` (NHWC and NCHW), ``upsampling2d``, ``pad``, the
registered batch norms, each loss of ``LOSS_OPS`` (with logits exactly 0
for the sigmoid cross-entropy) and ``yolo2_loss`` on grids with objects,
without any, with two objects whose best anchors tie, and at YOLO2's own
configuration (the five VOC anchors, 20 classes, a 13x13 grid).

Tolerances: float64 1e-10 of the largest magnitude (rounding of the same
arithmetic in another order), float32 1e-5 (1e-4 for the convolutions,
whose sums run in other orders; XLA's float32 transcendental functions
are approximations a few ulps off PyTorch's). Where the JAX op rounds to
float32 in a float64 call (the cross-entropies' float32 sum, the batch
norms' float32 gamma, beta and rsqrt), float32's 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import registry as jreg
from deeplearning4j_tpu_torch.ops import registry as preg
from deeplearning4j_tpu_torch.ops.loss import LOSS_OPS

TOL = {"float32": 1e-5, "float64": 1e-10}
CONV_TOL = {"float32": 1e-4, "float64": 1e-10}
DTYPES = ("float32", "float64")


def _rel(got, want):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want))) / max(
        float(np.max(np.abs(want))), 1e-30)


def check_op(name, inputs, attrs=None, grad=None, tol=None, seed=9,
             dtype="float64"):
    """``name``'s forward and its gradient with respect to the inputs at
    positions ``grad`` (default all floating ones) in both packages."""
    attrs = attrs or {}
    tol = tol or TOL[dtype]
    arrs = [np.asarray(a).astype(dtype) if np.asarray(a).dtype.kind == "f"
            else np.asarray(a) for a in inputs]
    grad = [i for i, a in enumerate(arrs) if a.dtype.kind == "f"] \
        if grad is None else grad
    op, pfn = jreg.get_op(name).fn, preg.get_op(name).fn

    def jfn(*a):
        return op(*a, **attrs)
    jout = jax.jit(jfn)(*[jnp.asarray(a) for a in arrs])
    pins = [torch.tensor(a, requires_grad=i in grad)
            for i, a in enumerate(arrs)]
    pout = pfn(*pins, **attrs)
    jout = jout[0] if isinstance(jout, tuple) else jout
    pout = pout[0] if isinstance(pout, tuple) else pout
    assert str(pout.dtype)[6:] == str(jout.dtype), (pout.dtype, jout.dtype)
    if str(jout.dtype) == "float32":        # a float32 accumulation
        tol = max(tol, TOL["float32"])
    assert _rel(pout, jout) <= tol, (name, "forward", _rel(pout, jout))
    cot = np.random.default_rng(seed).normal(size=np.shape(jout)).astype(
        str(jout.dtype))

    def f(*a):
        full = list(map(jnp.asarray, arrs))
        for i, v in zip(grad, a):
            full[i] = v
        out = jfn(*full)
        out = out[0] if isinstance(out, tuple) else out
        return jnp.sum(out * cot)
    jg = jax.jit(jax.grad(f, argnums=tuple(range(len(grad)))))(
        *[jnp.asarray(arrs[i]) for i in grad])
    (pout * torch.tensor(cot)).sum().backward()
    for i, g in zip(grad, jg):
        e = _rel(pins[i].grad, g)
        assert e <= tol, (name, "gradient", i, e)


def _x(shape, seed=0, scale=1.0):
    return scale * np.random.default_rng(seed).normal(size=shape)


ACTIVATION_OPS = ["identity", "relu", "relu6", "leaky_relu", "elu", "selu",
                  "gelu", "sigmoid", "hard_sigmoid", "tanh", "hard_tanh",
                  "softmax", "softplus", "softsign", "swish", "mish", "cube",
                  "thresholdedrelu", "rationaltanh", "rectifiedtanh"]


def test_every_activation_name_resolves_as_in_jax():
    from deeplearning4j_tpu.nn.activations import _ALIASES as JA
    from deeplearning4j_tpu_torch.nn.activations import _ALIASES as PA
    from deeplearning4j_tpu_torch.nn.activations import resolve_activation
    assert PA == JA and len(PA) == 25
    assert sorted(set(PA.values())) == sorted(ACTIVATION_OPS)
    with pytest.raises(ValueError, match="unknown activation"):
        resolve_activation("prelu")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ACTIVATION_OPS)
def test_activation_matches_jax(name, dtype):
    x = _x((4, 37), scale=3.0)
    # the bounds of the clipped ones, ReLU-made zeros and the threshold
    x[0, :8] = [0.0, 6.0, -1.0, 1.0, -2.5, 2.5, 0.0, 1.0]
    if name == "hard_sigmoid":
        # 0.2 * x + 0.5 on a bound: XLA fuses it into one rounding, so
        # whether JAX sees the tie depends on the program around it
        x[0, 4:6] = [-2.4, 2.4]
    tol = TOL[dtype] * (10 if dtype == "float32" else 1)
    check_op(name, [x], dtype=dtype, tol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_lrn_matches_jax_and_does_not_divide_alpha(dtype):
    x = _x((2, 7, 5, 4), seed=1)
    for fmt, arr in (("NCHW", x), ("NHWC", x.transpose(0, 2, 3, 1))):
        check_op("lrn", [arr], {"depth": 2, "bias": 2.0, "alpha": 1e-2,
                                "beta": 0.75, "data_format": fmt},
                 dtype=dtype)
    got = preg.get_op("lrn").fn(torch.tensor(x), depth=2, bias=2.0,
                                alpha=1e-2, beta=0.75)
    lib = torch.nn.functional.local_response_norm(torch.tensor(x), 5,
                                                  1e-2, 0.75, 2.0)
    assert _rel(got, lib.numpy()) > 1e-3


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("k,s", [(2, 1), (2, 2), (3, 1), (3, 2)])
def test_deconv2d_matches_jax(k, s, padding, dtype):
    x = _x((2, 5, 6, 3), seed=2)                       # NHWC, 3 in
    w = _x((k, k, 4, 3), seed=3, scale=0.5)            # (kH, kW, out, in)
    b = _x((4,), seed=4)
    check_op("deconv2d", [x, w, b], {"strides": (s, s), "padding": padding,
                                     "data_format": "NHWC"},
             dtype=dtype, tol=CONV_TOL[dtype])
    check_op("deconv2d", [x.transpose(0, 3, 1, 2), w],
             {"strides": (s, s), "padding": padding, "data_format": "NCHW"},
             dtype=dtype, tol=CONV_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mult", [1, 2])
def test_depthwise_and_separable_match_jax(mult, dtype):
    x = _x((2, 7, 6, 3), seed=5)
    dw = _x((3, 3, 3, mult), seed=6, scale=0.5)
    pw = _x((1, 1, 3 * mult, 5), seed=7, scale=0.5)
    for stride, pad in (((1, 1), "SAME"), ((2, 2), "SAME"),
                        ((1, 1), "VALID")):
        attrs = {"strides": stride, "padding": pad, "data_format": "NHWC"}
        check_op("depthwise_conv2d", [x, dw, _x((3 * mult,), seed=8)],
                 attrs, dtype=dtype, tol=CONV_TOL[dtype])
        check_op("separable_conv2d", [x, dw, pw, _x((5,), seed=9)], attrs,
                 dtype=dtype, tol=CONV_TOL[dtype])


def test_depthwise_output_channel_is_c_times_mult_plus_m():
    x = np.zeros((1, 1, 1, 2))
    x[..., 1] = 1.0                                    # only channel 1
    w = np.zeros((1, 1, 2, 3))
    w[0, 0, 1, :] = [10.0, 20.0, 30.0]
    out = preg.get_op("depthwise_conv2d").fn(
        torch.tensor(x), torch.tensor(w), data_format="NHWC")
    assert out.reshape(-1).tolist() == [0, 0, 0, 10, 20, 30]


@pytest.mark.parametrize("fmt", ["NHWC", "NCHW"])
@pytest.mark.parametrize("name", ["space_to_depth", "depth_to_space"])
def test_space_depth_match_jax_channel_order(name, fmt):
    x = _x((2, 4, 6, 8), seed=10)
    check_op(name, [x], {"block_size": 2, "data_format": fmt})


def test_space_to_depth_is_not_pixel_unshuffle():
    x = torch.arange(2 * 4 * 4, dtype=torch.float64).reshape(1, 2, 4, 4)
    got = preg.get_op("space_to_depth").fn(x, 2, "NCHW")
    assert not torch.equal(got, torch.nn.functional.pixel_unshuffle(x, 2))
    # channel order (block row, block column, c): c fastest
    assert got[0, :, 0, 0].tolist() == [0.0, 16.0, 1.0, 17.0, 4.0, 20.0,
                                         5.0, 21.0]


@pytest.mark.parametrize("fmt", ["NHWC", "NCHW"])
def test_upsampling_and_pad_match_jax(fmt):
    x = _x((2, 3, 4, 5), seed=11)
    check_op("upsampling2d", [x], {"factor": (2, 3), "data_format": fmt})
    check_op("pad", [x], {"paddings": ((0, 0), (1, 2), (0, 1), (2, 0))})


@pytest.mark.parametrize("dtype", DTYPES)
def test_batchnorm_ops_match_jax_per_channel(dtype):
    """The registered batch norms over axis 1 (NCHW and (B, n)) against
    JAX's; its per-tensor reduction at axis -1 is not followed (ROADMAP
    queue 3, facts)."""
    x = _x((4, 3, 5, 5), seed=12, scale=2.0) + 1.0
    g, b = _x((3,), seed=13) + 1.0, _x((3,), seed=14)
    mean, var = np.zeros(3), np.ones(3)
    attrs = {"momentum": 0.9, "epsilon": 1e-5, "axis": 1}
    # JAX casts gamma and beta to float32, and takes the inference norm's
    # rsqrt in float32: float32's tolerance in both dtypes
    tol = TOL["float32"]
    check_op("batchnorm_train", [x, g, b, mean, var], attrs, grad=[0],
             dtype=dtype, tol=tol)
    check_op("batchnorm", [x, mean + 0.5, var * 2, g, b],
             {"epsilon": 1e-5, "axis": 1}, grad=[0], dtype=dtype, tol=tol)
    x2 = _x((6, 3), seed=15)
    check_op("batchnorm_train", [x2, g, b, mean, var], attrs, grad=[0],
             dtype=dtype, tol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("loss", sorted(LOSS_OPS))
def test_each_loss_matches_jax(loss, dtype):
    from deeplearning4j_tpu.nn.layers import _LOSS_OPS
    assert LOSS_OPS == _LOSS_OPS
    name = LOSS_OPS[loss]
    rng = np.random.default_rng(16)
    pred = rng.normal(size=(6, 5))
    if name in ("poisson_loss", "kl_divergence_loss"):
        pred = np.abs(pred) + 0.1
    labels = np.eye(5)[rng.integers(0, 5, 6)]
    if name == "sigm_cross_entropy":
        pred[0, :3] = 0.0                  # exact zeros: JAX's ties
        labels = (rng.random((6, 5)) > 0.5).astype(np.float64)
    check_op(name, [pred, labels], grad=[0], dtype=dtype)


def _yolo_case(seed, objects=True, tie=False):
    rng = np.random.default_rng(seed)
    anchors = (1.0, 1.0, 2.0, 2.0)
    b, h, w, a, c = 2, 3, 3, 2, 3
    pred = rng.normal(size=(b, h, w, a * (5 + c)))
    lab = np.zeros((b, h, w, 4 + c))
    if objects:
        lab[0, 1, 1, :4] = (0.75, 0.5, 2.25, 2.0)
        lab[0, 1, 1, 4] = 1.0
        lab[1, 0, 2, :4] = (1.9, 0.2, 2.6, 1.1)
        lab[1, 0, 2, 6] = 1.0
    if tie:
        # a box of 1.5 x 1.5: IoU 1 / 2.25 with the 1x1 anchor and with
        # the 2x2 one alike; the first anchor is responsible, as argmax
        lab[1, 2, 0, :4] = (0.0, 1.0, 1.5, 2.5)
        lab[1, 2, 0, 5] = 1.0
    return pred, lab, {"anchors": anchors, "lambda_coord": 5.0,
                       "lambda_noobj": 0.5}


#: the zoo YOLO2's default anchors (the five VOC ones)
VOC_ANCHORS = (0.57273, 0.677385, 1.87446, 2.06253, 3.33843, 5.47434,
               7.88282, 3.52778, 9.77052, 9.16828)


def _yolo_voc_case(seed):
    """YOLO2's main-path configuration: the five VOC anchors, 20 classes,
    the 13x13 grid of a 416x416 input; three boxes an image of 0.5-4
    cells, each in a random cell with a random class."""
    rng = np.random.default_rng(seed)
    b, g, a, c = 2, 13, 5, 20
    pred = rng.normal(size=(b, g, g, a * (5 + c)))
    lab = np.zeros((b, g, g, 4 + c))
    for i in range(b):
        for cell in rng.choice(g * g, size=3, replace=False):
            r, col = divmod(int(cell), g)
            w, h = rng.uniform(0.5, 4.0, 2)
            cx, cy = col + rng.random(), r + rng.random()
            lab[i, r, col, :4] = (cx - w / 2, cy - h / 2, cx + w / 2,
                                  cy + h / 2)
            lab[i, r, col, 4 + rng.integers(c)] = 1.0
    return pred, lab, {"anchors": VOC_ANCHORS, "lambda_coord": 5.0,
                       "lambda_noobj": 0.5}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["objects", "empty", "tie", "voc"])
def test_yolo2_loss_matches_jax(case, dtype):
    if case == "voc":
        pred, lab, attrs = _yolo_voc_case(18)
    else:
        pred, lab, attrs = _yolo_case(17, objects=case != "empty",
                                      tie=case == "tie")
    check_op("yolo2_loss", [pred, lab], attrs, grad=[0], dtype=dtype,
             tol=10 * TOL[dtype])
