"""The zoo's models at their published input sizes: the parameter counts
and output shapes ``chip_smoke.py`` phase 28 holds each model on the
card to (``P28_PARAMS``, ``P28_OUTPUT``) are the port's builds at those
sizes, and YOLO2's (416x416, 20 classes, 5 anchors) and AlexNet's
(224x224, 1000 classes) parameter counts are the JAX networks'.

The builds draw no weights: ``np.random.default_rng`` is replaced by a
generator of zeros for the test (a zero-stride array a draw), so only
the shapes matter and the builds are quick; each network is dropped
before the next is built.
"""
import importlib.util
import pathlib

import numpy as np
import pytest

import deeplearning4j_tpu.zoo as jzoo
import deeplearning4j_tpu_torch.zoo as pzoo

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Zeros:
    """A numpy generator's draws as zero-stride arrays of zeros."""

    def normal(self, loc=0.0, scale=1.0, size=None):
        return np.broadcast_to(np.float64(0.0), size)

    def uniform(self, low=0.0, high=1.0, size=None):
        return np.broadcast_to(np.float64(0.0), size)


@pytest.fixture
def zero_draws(monkeypatch):
    monkeypatch.setattr(np.random, "default_rng",
                        lambda *a, **k: _Zeros())


PUBLISHED = ["YOLO2", "AlexNet", "SimpleCNN", "VGG16", "VGG19",
             "Darknet19", "TinyYOLO", "SqueezeNet", "UNet", "Xception",
             "InceptionResNetV1", "FaceNet", "NASNet"]


@pytest.mark.parametrize("name", PUBLISHED)
def test_published_count_is_the_one_phase_28_holds(name, zero_draws):
    net = getattr(pzoo, name)().build(device="cpu")
    n = net.num_params()
    del net
    assert n == _chip_smoke().P28_PARAMS[name]


@pytest.mark.parametrize("name", ["YOLO2", "AlexNet"])
def test_published_count_equals_the_jax_networks(name, zero_draws):
    from deeplearning4j_tpu.nn import ComputationGraph as JGraph
    from deeplearning4j_tpu.nn import MultiLayerNetwork as JMln
    conf = getattr(jzoo, name)().conf()
    jnet = (JGraph if hasattr(conf, "nodes") else JMln)(conf).init()
    n = sum(int(np.prod(a.shape))
            for a in jnet._sd_train.trainable_params().values())
    del jnet
    assert n == _chip_smoke().P28_PARAMS[name]


@pytest.mark.parametrize("name", sorted(_chip_smoke().P28_OUTPUT))
def test_published_output_shape_is_the_one_phase_28_holds(name, zero_draws):
    """``output`` of one image at the published size, on the CPU."""
    spec = getattr(pzoo, name)()
    net = spec.build(device="cpu")
    out = net.output(np.zeros((1, spec.channels, spec.height, spec.width),
                              np.float32))
    out = out[0] if isinstance(out, list) else out
    del net
    assert tuple(out.shape) == (1,) + _chip_smoke().P28_OUTPUT[name]
