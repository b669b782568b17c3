"""The layer API of the zoo's image models against the JAX package's:
weight initialisation, and every new layer in the network kinds that take
it, built from the same seed in both packages (float64; the JAX networks
NCHW, see ``tests/torch_zoo_pairs.py``), held as the models are: the
initial weights bit for bit, the inference output, one ``Sgd(1.0)`` step
(every gradient), then three ``Nesterovs(1e-2, 0.9)`` steps (the losses
and every parameter).

- ``MultiLayerNetwork`` (the port's NHWC body, and NCHW): convolutions
  without a bias and with ``bias_init``, batch norm, leaky ReLU and other
  activation layers, LRN, zero padding, SAME average and max pooling,
  deconvolution, depthwise and separable convolution, upsampling,
  cropping, space-to-depth and its inverse, global MAX pooling, a dense
  layer and an output layer of each loss function; a per-pixel
  ``CnnLossLayer`` head.
- ``ComputationGraph``: the same layers, two loss heads summed
  (``OutputLayer`` and ``LossLayer``), the center-loss head.

Tolerances: the JAX float64 batch norm casts gamma and beta to float32:
1e-6 of each tensor's magnitude (output 1e-5: the inference norm's
float32 rsqrt differs by an ulp between the packages); without a batch
norm, 1e-9.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.weights import init_weights as jinit
from deeplearning4j_tpu_torch.nn.weights import ALL_SCHEMES, init_weights
from deeplearning4j_tpu_torch.ops.loss import LOSS_OPS
from torch_zoo_pairs import check_nets, classes, conf_pair

NESTEROVS = ("Nesterovs", {"learning_rate": 1e-2, "momentum": 0.9})


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


SCHEMES = ALL_SCHEMES + ["VAR_SCALING_NORMAL_FAN_AVG"]


@pytest.mark.parametrize("scheme", SCHEMES)
def test_weight_init_draws_equal_jax(scheme):
    shape = (4, 4) if scheme == "IDENTITY" else (3, 3, 16, 32)
    a = init_weights(scheme, shape, np.random.default_rng(5))
    b = jinit(scheme, shape, np.random.default_rng(5))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scheme", [s for s in SCHEMES
                                    if s not in ("ZERO", "ONES",
                                                 "IDENTITY")])
def test_weight_init_moments_and_bounds(scheme):
    """HWIO (3, 3, 64, 128): fan_in 576, fan_out 1152."""
    fi, fo = 576, 1152
    w = init_weights(scheme, (3, 3, 64, 128), np.random.default_rng(0))
    normal = {"NORMAL": 1 / np.sqrt(fi),
              "XAVIER": np.sqrt(2 / (fi + fo)), "RELU": np.sqrt(2 / fi),
              "LECUN_NORMAL": np.sqrt(1 / fi),
              "VAR_SCALING_NORMAL_FAN_AVG": np.sqrt(2 / (fi + fo))}
    uniform = {"XAVIER_UNIFORM": np.sqrt(6 / (fi + fo)),
               "RELU_UNIFORM": np.sqrt(6 / fi),
               "LECUN_UNIFORM": np.sqrt(3 / fi), "UNIFORM": 1 / np.sqrt(fi),
               "SIGMOID_UNIFORM": 4 * np.sqrt(6 / (fi + fo))}
    n = w.size
    if scheme in normal:
        sd = normal[scheme]
    else:
        a = uniform[scheme]
        assert np.abs(w).max() <= a
        assert np.abs(w).max() > 0.99 * a
        sd = a / np.sqrt(3)
    assert abs(w.mean()) < 5 * sd / np.sqrt(n)
    assert abs(w.std() / sd - 1) < 0.02


def test_weight_init_constant_schemes_and_refusal():
    assert not init_weights("ZERO", (2, 3), None).any()
    assert (init_weights("ONES", (2, 3), None) == 1).all()
    np.testing.assert_array_equal(init_weights("identity", (3, 3), None),
                                  np.eye(3))
    with pytest.raises(ValueError, match="unknown weight init"):
        init_weights("ORTHOGONAL", (2, 2), np.random.default_rng(0))


def _cnn_layers(nn):
    return [
        nn.ConvolutionLayer(n_out=4, kernel_size=(3, 3), has_bias=False),
        nn.BatchNormalization(),
        nn.ActivationLayer(activation="leaky_relu"),
        nn.LocalResponseNormalization(k=2.0, n=3, alpha=1e-2, beta=0.75),
        nn.ZeroPaddingLayer(padding=(1, 0, 0, 1)),
        nn.SubsamplingLayer(pooling_type="AVG", kernel_size=(3, 3),
                            stride=(2, 2), convolution_mode="SAME"),
        nn.Deconvolution2DLayer(n_out=3, kernel_size=(3, 3), stride=(2, 2),
                                activation="elu"),
        nn.DepthwiseConvolution2DLayer(depth_multiplier=2,
                                       kernel_size=(3, 3), stride=(2, 2)),
        nn.SeparableConvolution2DLayer(n_out=5, kernel_size=(3, 3),
                                       activation="swish", bias_init=1.0),
        nn.Upsampling2DLayer(size=(2, 2)),
        nn.Cropping2DLayer(cropping=(1, 1, 0, 2)),
        nn.SpaceToDepthLayer(block_size=2),
        nn.ConvolutionLayer(n_out=4, kernel_size=(1, 1), bias_init=1.0,
                            convolution_mode="VALID", activation="mish"),
        nn.SubsamplingLayer(pooling_type="MAX", kernel_size=(3, 3),
                            stride=(1, 1), convolution_mode="SAME"),
    ]


def _mln(head):
    def make(nn, updater):
        b = (nn.NeuralNetConfiguration.builder().seed(6).updater(updater)
             .list())
        for layer in _cnn_layers(nn) + head(nn):
            b.layer(layer)
        return b.set_input_type(nn.InputType.convolutional(11, 10, 2)
                                ).build()
    return make


def _x(n=6, h=11, w=10, c=2, seed=1):
    return np.random.RandomState(seed).rand(n, c, h, w) - 0.3


@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
def test_mln_conv_family_matches_jax(layout):
    head = _mln(lambda nn: [nn.GlobalPoolingLayer(pooling_type="MAX"),
                            nn.DenseLayer(n_out=6, activation="selu"),
                            nn.OutputLayer(n_out=3)])
    check_nets(lambda upd: conf_pair(head, upd or NESTEROVS,
                                     port_layout=layout),
               _x(), classes(6, 3), 1e-6, 1e-6, out_tol=1e-5)


def test_mln_cnn_loss_head_matches_jax():
    head = _mln(lambda nn: [nn.ConvolutionLayer(
        n_out=1, kernel_size=(1, 1), convolution_mode="VALID"),
        nn.CnnLossLayer(loss_function="XENT", activation="sigmoid")])
    jnet, pnet = conf_pair(head, NESTEROVS)
    out = pnet.output(_x())
    assert out.shape == np.asarray(jnet.output(_x()).to_numpy()).shape
    assert out.shape[:2] == (6, 1)
    y = (np.random.RandomState(2).rand(*out.shape) > 0.5).astype(float)
    check_nets(lambda upd: conf_pair(head, upd or NESTEROVS), _x(), y,
               1e-6, 1e-6, out_tol=1e-5)


HEAD_ACT = {"MCXENT": "softmax", "NEGATIVELOGLIKELIHOOD": "softmax",
            "XENT": "sigmoid", "POISSON": "softplus",
            "KL_DIVERGENCE": "softmax", "COSINE_PROXIMITY": "tanh",
            "HINGE": "identity", "SQUARED_HINGE": "identity",
            "MSE": "identity", "L1": "hard_tanh"}


@pytest.mark.parametrize("loss", sorted(LOSS_OPS))
def test_output_layer_of_each_loss_matches_jax(loss):
    def make(nn, updater):
        return (nn.NeuralNetConfiguration.builder().seed(8)
                .updater(updater).list()
                .layer(nn.DenseLayer(n_out=7, activation="relu6",
                                     weight_init="RELU_UNIFORM"))
                .layer(nn.DropoutLayer(dropout=0.0))
                .layer(nn.OutputLayer(n_out=4, loss_function=loss,
                                      activation=HEAD_ACT[loss],
                                      weight_init="LECUN_NORMAL"))
                .set_input_type(nn.InputType.feed_forward(5)).build())
    x = np.random.RandomState(4).rand(9, 5)
    y = classes(9, 4, seed=3)
    # the cross-entropies sum their losses in float32 in both packages
    tol = 1e-6 if LOSS_OPS[loss] == "softmax_cross_entropy" else 1e-9
    check_nets(lambda upd: conf_pair(make, upd or NESTEROVS), x, y, tol,
               tol)


def _graph(nn, updater, center=False):
    g = (nn.NeuralNetConfiguration.builder().seed(9).updater(updater)
         .graph_builder().add_inputs("in")
         .set_input_types(nn.InputType.convolutional(11, 10, 2)))
    prev = "in"
    for i, layer in enumerate(_cnn_layers(nn)):
        g.add_layer(f"l{i}", layer, prev)
        prev = f"l{i}"
    g.add_layer("gap", nn.GlobalPoolingLayer(pooling_type="SUM"), prev)
    g.add_layer("gmax", nn.GlobalPoolingLayer(pooling_type="MAX"), prev)
    g.add_vertex("cat", nn.MergeVertex(), "gap", "gmax")
    g.add_layer("emb", nn.DenseLayer(n_out=6, activation="tanh"), "cat")
    if center:
        g.add_vertex("norm", nn.L2NormalizeVertex(), "emb")
        g.add_layer("out", nn.CenterLossOutputLayer(n_out=3, alpha=0.1,
                                                    lambda_=0.7), "norm")
        return g.set_outputs("out").build()
    g.add_layer("out", nn.OutputLayer(n_out=3), "emb")
    g.add_layer("aux", nn.LossLayer(loss_function="MSE",
                                    activation="sigmoid"), "emb")
    return g.set_outputs("out", "aux").build()


def test_graph_conv_family_and_two_loss_heads_match_jax():
    """Two loss heads, their losses summed: the labels of ``out`` and of
    ``aux`` in the graph's output order."""
    from torch_zoo_pairs import fit_both, rel, to_np
    x = _x(seed=5)
    ys = [classes(6, 3, seed=6), np.random.RandomState(7).rand(6, 6)]
    jnet, pnet = conf_pair(_graph, ("Sgd", {"learning_rate": 1.0}))
    w = jnet.params()
    for k, v in pnet.params().items():
        np.testing.assert_array_equal(v, w[k], err_msg=k)
    outs = pnet.output(x)
    assert [tuple(o.shape) for o in outs] == [(6, 3), (6, 6)]
    for o, j in zip(outs, jnet.output(x)):
        assert rel(to_np(o), to_np(j)) < 1e-5
    jl, pl = fit_both(jnet, pnet, x, ys, 6)
    np.testing.assert_allclose(pl, jl, rtol=1e-6)
    after_j, after_p = jnet.params(), pnet.params()
    for k in w:
        if not k.endswith(("_mean", "_var")):
            dj = after_j[k] - w[k]
            assert rel(after_p[k] - w[k], dj) < 1e-6, k


def test_graph_center_loss_head_matches_jax():
    make = lambda upd: conf_pair(lambda nn, u: _graph(nn, u, center=True),
                                 upd or NESTEROVS)
    check_nets(make, _x(seed=8), classes(6, 3, seed=9), 1e-6, 1e-6,
               out_tol=1e-5)
