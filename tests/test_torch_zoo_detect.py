"""YOLO2, TinyYOLO and Darknet19 of the port's zoo against the JAX
package's (``tests/torch_zoo_pairs.py``: the same classes, seed and
weights, float64, the JAX networks NCHW).

YOLO2 runs at the JAX test's size (64x64, 2 classes, anchors (1, 1, 2,
2): a 2x2 grid; ``tests/test_zoo_wave3.py:78-92``), TinyYOLO at its
(64x64), Darknet19 at its (32x32, 3 classes). Each: the initial
weights bit for bit, the parameter count, the inference output, one
``Sgd(1.0)`` step (every gradient as the parameters' change), then three
steps of the zoo's Adam(1e-3): the losses and every parameter.

Tolerances: the JAX float64 batch norm casts gamma and beta to float32,
so a gradient through it (and gamma's and beta's own) is held to 1e-6 of
its magnitude; the inference output to 1e-5 (the inference batch norm
takes ``rsqrt`` of the running variance in float32 in both packages, and
the two rsqrt implementations differ by an ulp, which 22 layers carry to
1e-6); after three Adam steps the losses to 1e-6 and every parameter to
1e-4 of its magnitude: Adam divides each update by the root of the
second moment, so an element whose gradient is at the level of the JAX
float32 casts (1e-7 of the tensor's) moves by up to the learning rate
either way.
"""
import numpy as np
import pytest
import torch

from torch_zoo_pairs import check_model, pair, to_np, yolo_labels

ANCHORS = (1.0, 1.0, 2.0, 2.0)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _images(n, hw, seed=4, channels=3):
    return np.random.RandomState(seed).rand(n, channels, hw, hw)


def test_yolo2_64x64_matches_jax():
    x = _images(6, 64)
    y = yolo_labels(6, 2, 2, seed=1)
    r = check_model("YOLO2", {"height": 64, "width": 64, "num_classes": 2,
                              "anchors": ANCHORS}, x, y, 1e-6, 1e-4,
                    out_tol=1e-5)
    assert r["gradient"] < 1e-6


def test_yolo2_loss_at_the_jax_tests_labels():
    """The JAX test's labels (one box in cell (1, 1) of every image): the
    loss of the training graph on the same weights and batch."""
    from torch_zoo_pairs import fit_both
    x = _images(2, 64)
    y = np.zeros((2, 6, 2, 2))
    y[:, 0:4, 1, 1] = (0.5, 0.5, 1.5, 1.5)
    y[:, 4, 1, 1] = 1.0
    jnet, pnet = pair("YOLO2", {"height": 64, "width": 64, "num_classes": 2,
                                "anchors": ANCHORS})
    jl, pl = fit_both(jnet, pnet, x, y, 2)
    np.testing.assert_allclose(pl, jl, rtol=1e-9)
    out = to_np(pnet.output(x))
    assert out.shape == (2, 2 * 7, 2, 2)


def test_yolo2_voc_anchors_adam_steps_match_jax():
    """The zoo's YOLO2 as it trains on the card (the five VOC anchors, 20
    classes, the zoo's Adam(1e-3)) at 64x64 (a 2x2 grid), four steps on
    one batch of two images with three boxes each: the first three
    steps' losses to 1e-6 of JAX's, the fourth to 1e-5 (the first update
    multiplies the loss some 700 times, and the third carries the JAX
    batch norm's float32 casts, 1e-7 of a step, to 1.7e-6). From the
    initial weights the first Adam(1e-3) step sends the JAX network's
    loss up a hundredfold and more before it falls: the rise of the
    card's YOLO2 losses is the JAX network's too."""
    from torch_zoo_pairs import fit_both
    rng = np.random.default_rng(0)
    x1 = _images(2, 64, seed=6)
    y1 = np.zeros((2, 24, 2, 2))
    for i in range(2):
        for cell in rng.choice(4, size=3, replace=False):
            r, col = divmod(int(cell), 2)
            w, h = rng.uniform(0.5, 4.0, 2)
            cx, cy = col + rng.random(), r + rng.random()
            y1[i, 0:4, r, col] = (cx - w / 2, cy - h / 2, cx + w / 2,
                                  cy + h / 2)
            y1[i, 4 + rng.integers(20), r, col] = 1.0
    jnet, pnet = pair("YOLO2", {"height": 64, "width": 64})
    assert pnet.conf.nodes[-1].op.anchors == jnet.conf.nodes[-1].op.anchors
    jl, pl = fit_both(jnet, pnet, np.concatenate([x1] * 4),
                      np.concatenate([y1] * 4), 2)
    np.testing.assert_allclose(pl[:3], jl[:3], rtol=1e-6)
    np.testing.assert_allclose(pl[3:], jl[3:], rtol=1e-5)
    assert jl[1] > 100 * jl[0] and jl[-1] < jl[1]


def test_tinyyolo_64x64_matches_jax_with_the_port_nhwc():
    """The port's MultiLayerNetwork in its default NHWC body against the
    JAX one in NCHW: the output grid goes back to NCHW in both."""
    x = _images(6, 64, seed=5)
    y = yolo_labels(6, 2, 2, seed=2)
    check_model("TinyYOLO", {"height": 64, "width": 64, "num_classes": 2,
                             "anchors": ANCHORS}, x, y, 1e-6, 1e-4,
                out_tol=1e-5)


def test_darknet19_64x64_matches_jax():
    from torch_zoo_pairs import classes
    x = _images(12, 64, seed=3)
    check_model("Darknet19", {"height": 64, "width": 64, "num_classes": 3},
                x, classes(12, 3), 1e-6, 1e-4, out_tol=1e-5)


def test_tinyyolo_and_darknet19_json_both_ways():
    from deeplearning4j_tpu.nn import MultiLayerConfiguration as JConf
    from deeplearning4j_tpu_torch.nn import MultiLayerConfiguration
    for name, kw in (("TinyYOLO", {"anchors": ANCHORS}), ("Darknet19", {})):
        jnet, pnet = pair(name, kw | {"height": 64, "width": 64})
        pj, jj = pnet.conf.to_json(), jnet.conf.to_json()
        back = MultiLayerConfiguration.from_json(jj)
        assert [type(l).__name__ for l in back.layers] == \
            [type(l).__name__ for l in pnet.conf.layers]
        assert back.layers[-1].to_json() == pnet.conf.layers[-1].to_json()
        assert len(JConf.from_json(pj).layers) == len(jnet.conf.layers)
