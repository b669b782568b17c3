"""SqueezeNet, UNet, Xception, InceptionResNetV1, FaceNet and NASNet of
the port's zoo (each a ``ComputationGraph``) against the JAX package's
(``tests/torch_zoo_pairs.py``: the same classes, seed and weights,
float64, the JAX graphs NCHW, dropout off): the initial weights bit for
bit, the parameter count, the inference output, one ``Sgd(1.0)`` step
(every gradient as the parameters' change), then three steps of the
zoo's Adam(1e-3) (Xception: Nesterovs, see ``UPDATERS``): the losses and
every parameter (FaceNet's center-loss
centers included, which the step writes).

Sizes are the JAX tests' (``tests/test_zoo_datasets_ext.py:47-75``,
``tests/test_zoo_wave3.py:40-75``): SqueezeNet 48x48, UNet 32x32 (one
channel, 4 features: deconvolutions, merges and a per-pixel XENT loss
on a sigmoid), Xception 71x71 with one middle block (separable
convolutions, SAME max pools), InceptionResNetV1 and FaceNet 64x64 with
one block of each kind (FaceNet: a 16-d L2-normalized embedding and the
center loss), NASNet 32x32 with one cell a stack (SAME average pools).

Tolerances: SqueezeNet and UNet hold no batch norm: 1e-9 of each
tensor's magnitude (output, gradients, losses), 1e-8 after three Adam
steps. The others' batch norms cast gamma and beta to float32 in the
JAX package: 1e-6 (the output 1e-5: the inference batch norm's float32
rsqrt differs by an ulp between the two), and their parameters after
three Adam steps 1e-4 (an element whose gradient is at the level of
those casts moves by up to the learning rate either way).
"""
import numpy as np
import pytest
import torch

from torch_zoo_pairs import check_model, classes, pair, to_np

MODELS = {
    "SqueezeNet": ({"height": 48, "width": 48, "num_classes": 3}, 3, 1e-9,
                   1e-8, None),
    "UNet": ({"height": 32, "width": 32, "channels": 1, "features": 4}, 1,
             1e-9, 1e-8, None),
    "Xception": ({"height": 71, "width": 71, "num_classes": 2,
                  "middle_blocks": 1}, 3, 1e-6, 1e-4, 1e-5),
    "InceptionResNetV1": ({"height": 64, "width": 64, "num_classes": 3,
                           "blocks_a": 1, "blocks_b": 1, "blocks_c": 1}, 3,
                          1e-6, 1e-4, 1e-5),
    "FaceNet": ({"height": 64, "width": 64, "num_classes": 3,
                 "embedding_size": 16, "blocks_a": 1, "blocks_b": 1,
                 "blocks_c": 1}, 3, 1e-6, 1e-4, 1e-5),
    "NASNet": ({"height": 32, "width": 32, "num_classes": 2,
                "cells_per_stack": 1, "filters": 8, "stem_filters": 8}, 3,
               1e-6, 1e-4, 1e-5),
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _data(name, n=6):
    kw, c = MODELS[name][0], MODELS[name][1]
    x = np.random.RandomState(3).rand(n, kw.get("channels", 3),
                                      kw["height"], kw["width"])
    if name == "UNet":
        return x, (x > 0.5).astype(np.float64)
    return x, classes(n, kw["num_classes"], seed=2)


#: Xception's three steps take Nesterovs: after Adam's first step, which
#: moves every element by the learning rate whatever its gradient's size,
#: the elements whose gradient the JAX float32 casts leave at rounding
#: level have moved either way, and its middle flow carries that to 0.4%
#: of some batch norm's beta by the third step (the losses still agree to
#: 1e-6)
UPDATERS = {"Xception": ("Nesterovs", {"learning_rate": 1e-2,
                                       "momentum": 0.9})}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_matches_jax(name):
    kw, _, tol, updater_tol, out_tol = MODELS[name]
    x, y = _data(name)
    check_model(name, kw, x, y, tol, updater_tol, out_tol=out_tol,
                updater=UPDATERS.get(name))


def test_facenet_embedding_is_l2_normalized_and_its_centers_move():
    """The ``embedding`` vertex is unit-norm; a training step moves the
    batch's classes' centers (a buffer the step writes), and only
    theirs."""
    _, pnet = pair("FaceNet", MODELS["FaceNet"][0])
    x, y = _data("FaceNet", 4)
    y = np.eye(3)[[0, 0, 1, 1]]
    emb = to_np(pnet.feed_forward(x)["embedding"])
    np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, atol=1e-9)
    before = pnet.params()["out_centers"]
    assert not before.any()
    pnet.fit(x, y, batch_size=4)
    after = pnet.params()["out_centers"]
    assert after[:2].any() and not after[2].any()
