"""SimpleCNN, AlexNet, VGG16 and VGG19 of the port's zoo (each a
``MultiLayerNetwork``) against the JAX package's
(``tests/torch_zoo_pairs.py``: the same classes, seed and weights,
float64, dropout off): the initial weights bit for bit, the parameter
count, the inference output, one ``Sgd(1.0)`` step (every gradient as
the parameters' change), three steps of the zoo's updater (the losses
and every parameter), and the configuration's JSON both ways.

Sizes are the JAX tests' (``tests/test_zoo.py:25-43``, ``test_zoo_wave3``):
SimpleCNN 48x48, AlexNet 67x67 (every layer, the LRNs included), VGG16
and VGG19 32x32. SimpleCNN flattens a map its batch norms produced, so
both packages run it NCHW; AlexNet and the VGGs have no batch norm and
run the default NHWC body in both (the flatten before their dense layers
follows the layout).

Tolerances: without a batch norm the two packages' float64 agree to
rounding: 1e-9 of each tensor's magnitude (output, gradients, losses),
1e-8 after three Nesterovs steps. SimpleCNN's batch norms cast gamma
and beta to float32 in the JAX package: 1e-6, the output 1e-5 (the
inference batch norm's float32 rsqrt differs by an ulp between the two),
its parameters after three Adam steps 1e-4 (an element whose gradient is
at the level of those casts moves by up to the learning rate either
way).
"""
import numpy as np
import pytest
import torch

from torch_zoo_pairs import check_model, classes, pair

MODELS = {
    "SimpleCNN": ({"height": 48, "width": 48, "num_classes": 5}, 1e-6,
                  1e-4, "both NCHW", 1e-5),
    "AlexNet": ({"height": 67, "width": 67, "num_classes": 10}, 1e-9, 1e-8,
                "NHWC", None),
    "VGG16": ({"height": 32, "width": 32, "num_classes": 10}, 1e-9, 1e-8,
              "NHWC", None),
    "VGG19": ({"height": 32, "width": 32, "num_classes": 2}, 1e-9, 1e-8,
              "NHWC", None),
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_matches_jax(name):
    kw, tol, updater_tol, layout, out_tol = MODELS[name]
    x = np.random.RandomState(7).rand(6, 3, kw["height"], kw["width"])
    y = classes(6, kw["num_classes"], seed=1)
    check_model(name, kw, x, y, tol, updater_tol, layout, out_tol=out_tol)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_configuration_json_both_ways(name):
    """Each package reads the other's JSON: the same layers, each layer's
    JSON the same; a network built from the JAX JSON starts from the same
    weights."""
    from deeplearning4j_tpu.nn import MultiLayerConfiguration as JConf
    from deeplearning4j_tpu_torch.nn import (MultiLayerConfiguration,
                                             MultiLayerNetwork)
    kw = MODELS[name][0]
    jnet, pnet = pair(name, kw, layout="NHWC", dropout=True)
    back = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    assert [l.to_json() for l in back.layers] == \
        [l.to_json() for l in pnet.conf.layers]
    jback = JConf.from_json(pnet.conf.to_json())
    assert [type(l).__name__ for l in jback.layers] == \
        [type(l).__name__ for l in jnet.conf.layers]
    net = MultiLayerNetwork(back).init(device="cpu")
    for k, v in net.params().items():
        np.testing.assert_array_equal(v, pnet.params()[k], err_msg=k)


def test_alexnet_drops_its_dense_layers_inputs_in_training_only():
    """AlexNet's two 4096-unit layers drop their inputs (dropout 0.5) in
    the training graph, as the JAX package records them; the inference
    graph holds no dropout."""
    _, pnet = pair("AlexNet", MODELS["AlexNet"][0], layout="NHWC",
                   dropout=True)
    train = [op for op in pnet.samediff.ops() if op.op == "dropout"]
    assert [op.attrs["p"] for op in train] == [0.5, 0.5]
    assert not [op for op in pnet._sd_infer.ops() if op.op == "dropout"]
