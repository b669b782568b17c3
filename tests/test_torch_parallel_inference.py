"""The port's ParallelInference and the host code it stands on, against
the JAX package.

Unit tests of the queue, the batcher, the metrics, the circuit breaker
and the admission controller are the JAX package's
(``tests/test_serving.py``, ``tests/test_serving_resilience.py``), run on
the port's classes; where the result is a value (bucket choice, padding,
scatter, histogram percentiles, breaker transitions, admission
estimates) the same inputs also go through the JAX classes and the two
must agree exactly.

Two networks are served in both packages, from the same weights, by
each mode of both servers, on the same seeded requests: the dense
network of the JAX serving tests (8 -> tanh 16 -> softmax 3) and the zoo
ResNet-50 at 32x32 with 4 classes (the JAX graph built NCHW, as
``tests/test_torch_resnet50.py`` builds it). ResNet-50's batch-norm
running statistics are first set from one seeded batch, so that its
outputs depend on its input as a trained network's do (at init the
softmax saturates on one class for every input).

Tolerances, float32 throughout, absolute on softmax probabilities: a
port server's outputs against the JAX server's within 1e-5 for the dense
network and 5e-4 for ResNet-50 (the packages' matmuls and convolutions
sum in different orders; through ResNet-50's 53 layers each package's
float32 output lies up to 1.7e-4 from the float64 forward on these
requests), and against the port's own ``output()`` on the same request
within 1e-6 for the dense network and 2e-5 for ResNet-50 (the same
arithmetic, but a padded bucket may take another convolution kernel:
1.5e-6 apart on these requests). Bit-equality is
asserted only inside the port: a request served alone and co-batched at
the same bucket. The JAX package does not hold bit-identity of padded
buckets on its CPU backend (its 7 failing BATCHED tests), so it is not
asked of it here.
"""
import sys
import threading
import time
from concurrent.futures import Future

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.serving as jserving
from deeplearning4j_tpu.learning.updaters import Adam as JAdam
from deeplearning4j_tpu.nn import ComputationGraph as JGraph
from deeplearning4j_tpu.nn import DenseLayer as JDense
from deeplearning4j_tpu.nn import InputType as JInputType
from deeplearning4j_tpu.nn import MergeVertex as JMerge
from deeplearning4j_tpu.nn import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn import OutputLayer as JOutput
from deeplearning4j_tpu.serving import resilience as jres
from deeplearning4j_tpu.zoo import ResNet50 as JResNet50
from deeplearning4j_tpu_torch import serving
from deeplearning4j_tpu_torch.kernels.measure import set_running_stats
from deeplearning4j_tpu_torch.learning import Adam
from deeplearning4j_tpu_torch.nn import (ComputationGraph, DenseLayer,
                                         InputType, MergeVertex,
                                         MultiLayerNetwork,
                                         NeuralNetConfiguration, OutputLayer)
from deeplearning4j_tpu_torch.serving import (
    Batch, BucketSpec, DynamicBatcher, InferenceMode,
    LatencyHistogram, LoadGenerator, ParallelInference, PoisonedRequestError,
    ReloadFailedError, RequestQueue, RequestTimeoutError, ResilienceConfig,
    RetryableServingError, ServerClosedError, ServerOverloadedError,
    ServingError, ServingMetrics, ServingTimeoutError, pad_to_bucket,
    pow2_buckets)
from deeplearning4j_tpu_torch.serving.resilience import (AdmissionController,
                                                         CircuitBreaker)
from deeplearning4j_tpu_torch.zoo import ResNet50

N_IN, N_OUT = 8, 3
TOL_JAX = {"dense": 1e-5, "resnet50": 5e-4}   # port server vs JAX server
TOL_OUTPUT = {"dense": 1e-6, "resnet50": 2e-5}  # vs the port's output()


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two CPU threads for torch here: the suite runs six test files at
    once, and the servers' timing tests must not starve."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# networks in both packages


def _dense_conf(pkg, seed=7):
    nnc, dense, out, itype, adam = {
        "port": (NeuralNetConfiguration, DenseLayer, OutputLayer, InputType,
                 Adam),
        "jax": (JNNC, JDense, JOutput, JInputType, JAdam)}[pkg]
    return (nnc.builder().seed(seed).updater(adam(1e-3)).list()
            .layer(dense(n_out=16, activation="tanh"))
            .layer(out(n_out=N_OUT, loss_function="MCXENT"))
            .set_input_type(itype.feed_forward(N_IN)).build())


def _net(seed=7):
    return MultiLayerNetwork(_dense_conf("port", seed)).init(device="cpu")


def _dense_pair():
    jnet = JMLN(_dense_conf("jax")).init()
    pnet = _net()
    jp = jnet.params()
    for n, v in pnet.params().items():
        np.testing.assert_array_equal(v, np.asarray(jp[n]), err_msg=n)
    return jnet, pnet


def _calibrated_resnet(device="cpu", hw=32, classes=4, seed=3):
    """The zoo ResNet-50 with its batch norms' running statistics set to
    one seeded batch's."""
    net = ResNet50(height=hw, width=hw, num_classes=classes).build(
        device=device)
    set_running_stats(net, np.random.default_rng(seed).uniform(
        size=(16, 3, hw, hw)))
    return net


def _resnet_pair():
    pnet = _calibrated_resnet()
    conf = JResNet50(height=32, width=32, num_classes=4).conf()
    conf.cnn_data_format = "NCHW"
    jnet = JGraph(conf).init()
    params = pnet.params()
    assert set(params) == set(jnet.params())
    for n, v in params.items():
        jnet._sd_train._arrays[n] = jnp.asarray(v)
    return jnet, pnet


MODELS = {"dense": (_dense_pair, (N_IN,), 8),
          "resnet50": (_resnet_pair, (3, 32, 32), 4)}


@pytest.fixture(scope="module")
def pairs():
    return {}


def _pair(pairs, model):
    if model not in pairs:
        pairs[model] = MODELS[model][0]()
    return pairs[model]


def _direct(net, x):
    out = net.output(x)
    return (out[0] if isinstance(out, list) else out).numpy()


def _requests(model, n=6, seed=0):
    shape = MODELS[model][1]
    rng = np.random.default_rng(seed)
    return [rng.uniform(size=(int(rng.integers(1, 4)),) + shape)
            .astype(np.float32) for _ in range(n)]


def _serve(pkg_serving, net, mode, xs, **kw):
    kw.setdefault("max_delay_ms", 20.0)
    if mode is not pkg_serving.InferenceMode.BATCHED:
        kw.pop("max_delay_ms")
    with pkg_serving.ParallelInference(net, mode=mode, analyze=False,
                                       **kw) as pi:
        futs = [pi.submit(x) for x in xs]
        return [np.asarray(f.result(timeout=120)) for f in futs]


@pytest.mark.parametrize("mode", ["SEQUENTIAL", "INPLACE", "BATCHED"])
@pytest.mark.parametrize("model", ["dense", "resnet50"])
def test_each_mode_serves_the_jax_servers_outputs(pairs, model, mode):
    jnet, pnet = _pair(pairs, model)
    xs = _requests(model)
    bucket = MODELS[model][2]
    kw = {"max_batch_size": bucket, "buckets": (bucket,)} \
        if mode == "BATCHED" else {}
    got = _serve(serving, pnet, getattr(InferenceMode, mode), xs, **kw)
    want = _serve(jserving, jnet, getattr(jserving.InferenceMode, mode), xs,
                  **kw)
    for x, g, w in zip(xs, got, want):
        assert g.shape == w.shape and g.shape[0] == len(x)
        assert np.all(np.isfinite(g))
        np.testing.assert_allclose(g, _direct(pnet, x), rtol=0,
                                   atol=TOL_OUTPUT[model])
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL_JAX[model])
    # the answers depend on the request
    assert np.abs(got[0][0] - got[1][0]).max() > 100 * TOL_JAX[model]


@pytest.mark.parametrize("model", ["dense", "resnet50"])
def test_alone_and_cobatched_rows_are_bit_equal(pairs, model):
    _, pnet = _pair(pairs, model)
    xs = _requests(model, n=3, seed=1)
    bucket = MODELS[model][2] * 2
    with ParallelInference(pnet, mode=InferenceMode.BATCHED, workers=1,
                           max_batch_size=bucket, buckets=(bucket,),
                           max_delay_ms=500.0) as pi:
        alone = [pi.output(x) for x in xs]
        before = pi.metrics.counters["batches_dispatched"]
        futs = [pi.submit(x) for x in xs]
        together = [f.result(timeout=60) for f in futs]
        assert pi.metrics.counters["batches_dispatched"] == before + 1
    for a, t in zip(alone, together):
        assert np.array_equal(a, t)


def test_single_example_is_squeezed_and_multi_input_graph_served():
    pnet = _net()
    x = np.random.default_rng(2).normal(size=(4, N_IN)).astype(np.float32)
    with ParallelInference(pnet, mode=InferenceMode.INPLACE) as pi:
        one = pi.output(x[0])
        assert one.shape == (N_OUT,)
        np.testing.assert_allclose(one, _direct(pnet, x[:1])[0], rtol=0,
                                   atol=TOL_OUTPUT["dense"])
    confs = {}
    for pkg, (nnc, dense, out, itype, adam, merge) in {
            "port": (NeuralNetConfiguration, DenseLayer, OutputLayer,
                     InputType, Adam, MergeVertex),
            "jax": (JNNC, JDense, JOutput, JInputType, JAdam,
                    JMerge)}.items():
        confs[pkg] = (nnc.builder().seed(5).updater(adam(1e-3))
                      .graph_builder().add_inputs("inA", "inB")
                      .set_input_types(itype.feed_forward(3),
                                       itype.feed_forward(2))
                      .add_layer("dA", dense(n_out=8, activation="tanh"),
                                 "inA")
                      .add_layer("dB", dense(n_out=8, activation="tanh"),
                                 "inB")
                      .add_vertex("merge", merge(), "dA", "dB")
                      .add_layer("out", out(n_out=2), "merge")
                      .set_outputs("out").build())
    jnet = JGraph(confs["jax"]).init()
    gnet = ComputationGraph(confs["port"]).init(device="cpu")
    from deeplearning4j_tpu_torch.convert import params_from_jax
    gnet.model.load_state_dict(params_from_jax(jnet.params()))
    rng = np.random.default_rng(0)
    a = rng.normal(size=(4, 3)).astype(np.float32)
    b = rng.normal(size=(4, 2)).astype(np.float32)
    with ParallelInference(gnet, mode=InferenceMode.SEQUENTIAL) as pi:
        served = pi.output((a, b))
    with jserving.ParallelInference(jnet, mode=jserving.InferenceMode
                                    .SEQUENTIAL, analyze=False) as jpi:
        jserved = np.asarray(jpi.output((a, b)))
    np.testing.assert_allclose(served, jserved, rtol=0,
                               atol=TOL_JAX["dense"])
    np.testing.assert_allclose(served, gnet.output(a, b)[0].numpy(), rtol=0,
                               atol=TOL_OUTPUT["dense"])
    with pytest.raises(ValueError, match="single-input"):
        ParallelInference(gnet, mode=InferenceMode.BATCHED)


def test_inplace_rejects_timeout_and_uninit_network_is_guarded():
    pnet = _net()
    with ParallelInference(pnet, mode=InferenceMode.INPLACE) as pi:
        with pytest.raises(ValueError, match="no queue"):
            pi.output(np.zeros((1, N_IN), np.float32), timeout_ms=5)
        with pytest.raises(ValueError, match="expects shape"):
            pi.output(np.zeros((1, N_IN + 1), np.float32))
    with pytest.raises(ValueError, match="no queue wait"):
        ParallelInference(pnet, mode=InferenceMode.INPLACE,
                          default_timeout_ms=5)
    with pytest.raises(RuntimeError, match="init"):
        ParallelInference(MultiLayerNetwork(_dense_conf("port")))
    conf = (NeuralNetConfiguration.builder().seed(5).graph_builder()
            .add_inputs("in").set_input_types(InputType.feed_forward(3))
            .add_layer("out", OutputLayer(n_out=2), "in")
            .set_outputs("out").build())
    with pytest.raises(RuntimeError, match="init"):
        ParallelInference(ComputationGraph(conf))


def _fit_data(rng, n_in, n_out, shape=None):
    X = rng.normal(size=(64,) + (shape or (n_in,))).astype(np.float32)
    Y = np.eye(n_out, dtype=np.float32)[rng.integers(0, n_out, size=64)]
    return X, Y


@pytest.mark.parametrize("model", ["dense", "graph"])
def test_fit_changes_served_outputs_only_through_update_model(model):
    rng = np.random.default_rng(3)
    if model == "dense":
        net = _net()
        X, Y = _fit_data(rng, N_IN, N_OUT)
        x = X[:4]
    else:
        net = ResNet50(height=32, width=32, num_classes=4).build(
            device="cpu")
        X, Y = _fit_data(rng, 0, 4, shape=(3, 32, 32))
        X, Y, x = X[:8], Y[:8], X[8:12]
    with ParallelInference(net, mode=InferenceMode.INPLACE) as pi:
        before = pi.output(x)
        direct_before = _direct(net, x)
        net.fit(X, Y, epochs=1, batch_size=8)
        # the network moved; the server still serves its own copy
        assert not np.array_equal(_direct(net, x), direct_before)
        assert np.array_equal(pi.output(x), before)
        pi.update_model()
        after = pi.output(x)
        assert not np.array_equal(before, after)
        np.testing.assert_allclose(
            after, _direct(net, x), rtol=0,
            atol=TOL_OUTPUT["dense" if model == "dense" else "resnet50"])


@pytest.mark.parametrize("model", ["dense", "graph"])
def test_serving_spec_holds_its_own_tensors(model):
    if model == "dense":
        net = _net()
        sd, ins, outs, sync = net.serving_spec()
        assert (ins, outs) == (["input"], ["output"])
        assert sd.infer_shape("input") == (-1, N_IN)
        mine = sd.trainable_params()
        theirs = net.samediff.trainable_params()
    else:
        net = ResNet50(height=32, width=32, num_classes=4).build(
            device="cpu")
        sd, ins, outs, sync = net.serving_spec()
        assert (ins, outs) == (["input"], ["output"])
        assert sd.infer_shape("input") == (-1, 3, 32, 32)
        assert not sd.model.training
        mine = sd.model.state_dict()
        theirs = net.model.state_dict()
    assert sd.device == net.device
    sync()
    assert set(theirs) <= set(mine)
    for k, t in theirs.items():
        assert mine[k].data_ptr() != t.data_ptr(), k
        assert torch.equal(mine[k], t), k


def test_forward_macs_and_running_stats_case_builders():
    """``measure.forward_macs`` (phase 25's bound) against a hand count,
    and ``measure.set_running_stats`` (its input-dependent outputs)."""
    from deeplearning4j_tpu_torch.kernels.measure import forward_macs
    from deeplearning4j_tpu_torch.nn import (ConvolutionLayer,
                                             GlobalPoolingLayer)
    conf = (NeuralNetConfiguration.builder().graph_builder()
            .add_inputs("in").set_input_types(InputType.convolutional(8, 8, 3))
            .add_layer("c", ConvolutionLayer(n_out=5, stride=(2, 2)), "in")
            .add_layer("g", GlobalPoolingLayer(), "c")
            .add_layer("out", OutputLayer(n_out=4), "g")
            .set_outputs("out").build())
    net = ComputationGraph(conf).init(device="cpu")
    # SAME padding, stride 2: a 4x4 output of 5 channels, 3x3x3 a tap
    assert forward_macs(net, 8) == {"conv": 4 * 4 * 5 * 3 * 3 * 3,
                                    "dense": 5 * 4}
    big = ResNet50(height=224, width=224, num_classes=1000).build(
        device="cpu")
    macs = forward_macs(big, 224)
    # ResNet-50 v1 (the stride on the first 1x1 of a block): 3.83 GMAC
    assert 3.8e9 < macs["conv"] < 3.9e9 and macs["dense"] == 2048 * 1000
    net = _calibrated_resnet()
    stats = [m for m in net.model.modules() if hasattr(m, "var")]
    assert len(stats) == 53 and not net.model.training
    assert all(float(m.var.min()) != 1.0 for m in stats)


# ---------------------------------------------------------------------------
# queue: backpressure, deadlines, drain


def _req(rows=1, deadline=None, seed=0, pkg=serving):
    x = np.random.default_rng(seed).normal(size=(rows, N_IN)) \
        .astype(np.float32)
    return pkg.InferenceRequest(x=[x], future=Future(), rows=rows,
                                deadline=deadline)


def test_queue_backpressure_overflow_is_typed():
    q = RequestQueue(max_queue_len=2)
    q.put(_req())
    q.put(_req())
    with pytest.raises(ServerOverloadedError):
        q.put(_req())


@pytest.mark.parametrize("rows,max_rows,strict,want", [
    ((3, 3, 3), 8, True, [3, 3]),
    ((5,), 1, False, [5]),
    ((5,), 2, True, []),
    ((2, 2, 9), 4, False, [2, 2]),
    ((1, 1, 1, 1, 1), 3, True, [1, 1, 1])])
def test_queue_take_budget_matches_jax(rows, max_rows, strict, want):
    got = {}
    for pkg in (serving, jserving):
        q = pkg.RequestQueue(8)
        for s in rows:
            q.put(_req(rows=s, pkg=pkg))
        got[pkg.__name__] = [r.rows for r in q.take(
            max_rows=max_rows, timeout=0, strict=strict)]
        assert q.pending_rows() == sum(rows) - sum(got[pkg.__name__])
    assert got["deeplearning4j_tpu_torch.serving"] == want
    assert got["deeplearning4j_tpu.serving"] == want


def test_queue_deadline_expires_at_dispatch():
    q = RequestQueue(8)
    dead = _req(rows=1, deadline=time.monotonic() - 0.001)
    live = _req(rows=1)
    q.put(dead)
    q.put(live)
    assert q.take(max_rows=4, timeout=0) == [live]
    with pytest.raises(RequestTimeoutError):
        dead.future.result(timeout=0)
    assert q.timed_out_count() == 1


def test_queue_close_without_drain_fails_pending():
    q = RequestQueue(8)
    r = _req()
    q.put(r)
    assert not q.closed
    q.close(drain=False)
    assert q.closed
    with pytest.raises(ServerClosedError):
        r.future.result(timeout=0)
    with pytest.raises(ServerClosedError):
        q.put(_req())


def test_queue_requeue_front_and_rows_accounting():
    q = RequestQueue(4)
    a, b = _req(rows=2, seed=0), _req(rows=3, seed=1)
    q.put(a)
    q.put(b)
    assert q.pending_rows() == 5
    got = q.take(max_rows=2, timeout=0)
    assert len(got) == 1 and got[0] is a
    assert q.pending_rows() == 3
    q.requeue(a)                    # crash recovery: back to the FRONT
    assert q.pending_rows() == 5
    got2 = q.take(max_rows=8, timeout=0)
    assert got2[0] is a and got2[1] is b
    assert q.pending_rows() == 0
    q.close(drain=True)
    q.requeue(a)                    # allowed mid-drain
    q2 = RequestQueue(2)
    q2.close(drain=False)
    with pytest.raises(ServerClosedError):
        q2.requeue(_req())


def test_complete_after_deadline_is_servingtimeout():
    req = _req(rows=1, deadline=time.monotonic() - 0.01)
    assert req.complete([np.zeros((1, N_OUT), np.float32)]) is False
    with pytest.raises(ServingTimeoutError):
        req.future.result(timeout=0)
    live = _req(rows=1, deadline=time.monotonic() + 60)
    assert live.complete([np.zeros((1, N_OUT), np.float32)]) is True
    assert live.future.result(timeout=0).shape == (1, N_OUT)
    assert issubclass(ServingTimeoutError, RequestTimeoutError)


@pytest.mark.parametrize("squeeze,n_out", [(False, 1), (True, 1),
                                           (False, 2), (True, 2)])
def test_collapse_outputs_matches_jax(squeeze, n_out):
    outs = [np.arange(6.0).reshape(2, 3) + k for k in range(n_out)]
    got = serving.queue.collapse_outputs(outs, squeeze)
    want = jserving.queue.collapse_outputs(outs, squeeze)
    if n_out == 1:
        assert np.array_equal(got, want)
    else:
        assert len(got) == len(want) == n_out
        for g, w in zip(got, want):
            assert np.array_equal(g, w)


# ---------------------------------------------------------------------------
# batcher + buckets


@pytest.mark.parametrize("cap,n", [(32, 4), (8, 2), (1, 4), (48, 4),
                                   (7, 3), (64, 6)])
def test_pow2_buckets_match_jax(cap, n):
    assert pow2_buckets(cap, n) == jserving.pow2_buckets(cap, n)
    assert pow2_buckets(32) == (4, 8, 16, 32)
    assert pow2_buckets(8, n_buckets=2) == (4, 8)


def test_bucket_spec_matches_jax_at_every_row_count():
    spec, jspec = BucketSpec((4, 8, 16, 32)), jserving.BucketSpec(
        (4, 8, 16, 32))
    assert [spec.bucket_for(r) for r in range(1, 33)] == \
        [jspec.bucket_for(r) for r in range(1, 33)]
    assert spec.bucket_for(1) == 4 and spec.bucket_for(5) == 8
    for s in (spec, jspec):
        with pytest.raises(ValueError):
            s.bucket_for(33)


def test_pad_to_bucket_zero_pads_as_jax():
    a = np.ones((3, 2), np.float32)
    b = np.full((2, 2), 2.0, np.float32)
    out = pad_to_bucket([a, b], 8)
    assert out.shape == (8, 2)
    np.testing.assert_array_equal(out[:3], a)
    np.testing.assert_array_equal(out[3:5], b)
    np.testing.assert_array_equal(out[5:], 0.0)
    np.testing.assert_array_equal(out, jserving.pad_to_bucket([a, b], 8))
    with pytest.raises(ValueError):
        pad_to_bucket([a, b], 4)


def test_batcher_coalesces_and_pads_as_jax():
    batches = []
    for pkg in (serving, jserving):
        q = pkg.RequestQueue(16)
        for i in range(5):
            q.put(_req(rows=3, seed=i, pkg=pkg))
        batcher = pkg.DynamicBatcher(q, max_batch_size=8, max_delay_ms=1.0,
                                     buckets=(4, 8))
        batches.append(batcher.next_batch(poll_timeout=0.5))
    batch, jbatch = batches
    assert isinstance(batch, Batch)
    assert len(batch.requests) == 2         # 3+3 rows; a third overshoots
    assert (batch.rows, batch.bucket, batch.padding) == (6, 8, 2)
    assert batch.features.shape == (8, N_IN)
    np.testing.assert_array_equal(batch.features[6:], 0.0)
    assert (jbatch.rows, jbatch.bucket, jbatch.padding) == (6, 8, 2)
    np.testing.assert_array_equal(batch.features, jbatch.features)
    with pytest.raises(ValueError, match="max_batch_size"):
        DynamicBatcher(RequestQueue(4), max_batch_size=16, buckets=(4, 8))


def test_batch_resolve_scatters_rows_as_jax():
    out = np.arange(8 * N_OUT, dtype=np.float32).reshape(8, N_OUT)
    results = []
    for pkg in (serving, jserving):
        reqs = [_req(rows=2, seed=0, pkg=pkg), _req(rows=3, seed=1, pkg=pkg)]
        batch = pkg.Batch(requests=reqs,
                          features=np.zeros((8, N_IN), np.float32), rows=5,
                          bucket=8)
        assert batch.resolve([out]) == []
        results.append([r.future.result(timeout=0) for r in reqs])
    for got, want in zip(*results):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(results[0][0], out[:2])
    np.testing.assert_array_equal(results[0][1], out[2:5])
    reqs = [_req(rows=1), _req(rows=1, deadline=time.monotonic() - 1)]
    batch = Batch(requests=reqs, features=np.zeros((4, N_IN), np.float32),
                  rows=2, bucket=4)
    assert batch.resolve([out]) == [reqs[1]]
    with pytest.raises(ServingTimeoutError):
        reqs[1].future.result(timeout=0)
    failed = _req()
    Batch(requests=[failed], features=out, rows=1, bucket=4).fail(
        ServingError("boom"))
    with pytest.raises(ServingError, match="boom"):
        failed.future.result(timeout=0)


# ---------------------------------------------------------------------------
# metrics


@pytest.mark.parametrize("samples", [(1.0, 2.0, 3.0, 100.0),
                                     tuple(np.linspace(0.01, 900.0, 97)),
                                     (0.5,) * 40 + (250.0,)])
def test_latency_histogram_percentiles_match_jax(samples):
    h, jh = LatencyHistogram(), jserving.LatencyHistogram()
    for ms in samples:
        h.record(ms)
        jh.record(ms)
    assert h.summary() == jh.summary()
    assert h.percentile(50) <= h.percentile(95) <= h.percentile(99) \
        <= h.max_ms
    assert h.summary()["low_sample"] is (len(samples) < 32)


def test_padding_waste_and_mean_batch_size_match_jax():
    m, jm = ServingMetrics(), jserving.ServingMetrics()
    for rows, pad in ((6, 2), (8, 0), (1, 3), (0, 0)):
        m.observe_batch(rows=rows, padding=pad, exec_ms=1.0)
        jm.observe_batch(rows=rows, padding=pad, exec_ms=1.0)
    assert m.padding_waste() == pytest.approx(5 / 20)
    assert m.mean_batch_size() == pytest.approx(15 / 4)
    assert m.padding_waste() == jm.padding_waste()
    assert m.mean_batch_size() == jm.mean_batch_size()
    m.set_resilience(breaker_state="open")
    rec, jrec = m.to_record(), jm.to_record()
    assert set(rec) == set(jrec)
    assert set(rec["counters"]) == set(jrec["counters"])
    assert rec["batch"]["padding_waste"] == jrec["batch"]["padding_waste"]
    assert rec["batch"]["size_hist"] == jrec["batch"]["size_hist"]
    assert rec["resilience"] == {"breaker_state": "open"}
    assert "breaker=open" in m.stats()

    class Sink(list):
        put = list.append
    sink = Sink()
    assert m.publish(sink) is sink[0] and sink[0]["type"] == "serving"


# ---------------------------------------------------------------------------
# circuit breaker and admission: the JAX classes alongside


def _breaker_script(cls):
    clock = {"t": 0.0}
    transitions = []
    br = cls(failure_threshold=3, reset_timeout_s=1.0,
             on_transition=lambda o, n: transitions.append((o, n)),
             clock=lambda: clock["t"])
    seen = [br.state]
    for step in ("f", "f", "s", "f", "f", "f", "reject", "acquire",
                 1.5, "reject", "acquire", "acquire", "f", 3.0, "acquire",
                 "s"):
        if isinstance(step, float):
            clock["t"] = step
        elif step == "f":
            br.on_failure()
        elif step == "s":
            br.on_success()
        elif step == "reject":
            seen.append(br.reject_for())
        else:
            seen.append(br.acquire())
        seen.append(br.state)
    return seen, transitions


def test_breaker_state_machine_matches_jax():
    seen, transitions = _breaker_script(CircuitBreaker)
    assert (seen, transitions) == _breaker_script(jres.CircuitBreaker)
    assert ("closed", "open") in transitions
    assert ("open", "half_open") in transitions
    assert ("half_open", "open") in transitions
    assert ("half_open", "closed") in transitions
    assert seen[-1] == "closed"


def test_breaker_release_returns_unused_probe():
    clock = {"t": 0.0}
    br = CircuitBreaker(failure_threshold=1, reset_timeout_s=0.5,
                        clock=lambda: clock["t"])
    br.on_failure()
    clock["t"] = 1.0
    ok, _ = br.acquire()
    assert ok and br.state == "half_open"
    assert br.acquire()[0] is False
    br.release()                    # dispatched nothing (empty poll)
    assert br.acquire()[0] is True
    with pytest.raises(ValueError):
        CircuitBreaker(failure_threshold=0)


@pytest.mark.parametrize("pending,per,samples", [
    (64, 32, (10.0,) * 4), (1, 32, (10.0,) * 4), (0, 32, (10.0,) * 4),
    (3, 1, (10.0,) * 4), (100, 8, (1.0, 5.0, 9.0, 40.0, 3.0)),
    (64, 32, (10.0,) * 3)])
def test_admission_estimates_match_jax(pending, per, samples):
    ac = AdmissionController(window=16, percentile=95.0, min_samples=4)
    jac = jres.AdmissionController(window=16, percentile=95.0,
                                   min_samples=4)
    for ms in samples:
        ac.observe(ms)
        jac.observe(ms)
    assert len(ac) == len(jac) == len(samples)
    assert ac.estimate_wait_ms(pending, per) == \
        jac.estimate_wait_ms(pending, per)
    assert ac.exec_ms() == jac.exec_ms()
    assert ac.retry_hint_s(pending, per) == jac.retry_hint_s(pending, per)
    if len(samples) < 4:
        assert ac.estimate_wait_ms(pending, per) is None


def test_typed_errors_round_trip_the_wire_as_jax():
    e = ServerOverloadedError("full", retry_after_s=1.5)
    assert e.to_wire() == jserving.ServerOverloadedError(
        "full", retry_after_s=1.5).to_wire()
    back = RetryableServingError.from_wire(e.to_wire())
    assert type(back) is ServerOverloadedError
    assert back.retry_after_s == 1.5 and str(back) == "full"
    unknown = RetryableServingError.from_wire(
        {"kind": "NewerShed", "message": "m", "retry_after_s": None})
    assert type(unknown) is RetryableServingError
    assert unknown.retry_after_s is None
    assert ServerOverloadedError("y").retry_after_s is None
    p = PoisonedRequestError("bad", request_id=7)
    assert p.request_id == 7 and isinstance(p, ServingError)
    r = ReloadFailedError("no", report={"step": 1}, rolled_back=True)
    assert r.report == {"step": 1} and r.rolled_back


def test_resilience_config_normalize():
    assert ResilienceConfig.normalize(None) is None
    assert ResilienceConfig.normalize(False) is None
    assert isinstance(ResilienceConfig.normalize(True), ResilienceConfig)
    cfg = ResilienceConfig(breaker_reset_s=9.0)
    assert ResilienceConfig.normalize(cfg) is cfg
    with pytest.raises(TypeError):
        ResilienceConfig.normalize("yes")


# ---------------------------------------------------------------------------
# server behaviour: backpressure, deadlines, drain


def _wait_until(cond, timeout=10.0, interval=0.005):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return cond()


def _gated(pi, gate):
    orig = pi._execute
    pi._execute = lambda *a, **k: (gate.wait(10), orig(*a, **k))[1]
    return orig


def _one_row_server(net, **kw):
    return ParallelInference(net, mode=InferenceMode.BATCHED, workers=1,
                             max_batch_size=1, buckets=(1,),
                             max_delay_ms=0.5, **kw)


def test_server_backpressure_rejection():
    pnet = _net()
    gate = threading.Event()
    pi = _one_row_server(pnet, max_queue_len=2)
    _gated(pi, gate)
    try:
        first = pi.submit(np.zeros((1, N_IN), np.float32))
        assert _wait_until(lambda: pi._queue.pending() == 0)
        pi.submit(np.zeros((1, N_IN), np.float32))
        pi.submit(np.zeros((1, N_IN), np.float32))
        with pytest.raises(ServerOverloadedError):
            pi.submit(np.zeros((1, N_IN), np.float32))
        assert pi.metrics.counters["requests_rejected"] == 1
    finally:
        gate.set()
        pi.shutdown()
    assert first.result(timeout=10) is not None


def test_server_deadline_expiry_typed_not_hanging():
    pnet = _net()
    gate = threading.Event()
    pi = _one_row_server(pnet, max_queue_len=8)
    _gated(pi, gate)
    try:
        pi.submit(np.zeros((1, N_IN), np.float32))      # occupies the worker
        assert _wait_until(lambda: pi._queue.pending() == 0)
        doomed = pi.submit(np.zeros((1, N_IN), np.float32), timeout_ms=20)
        time.sleep(0.05)                                # deadline passes
        gate.set()
        with pytest.raises(RequestTimeoutError):
            doomed.result(timeout=10)
        assert pi.metrics.counters["requests_timed_out"] == 1
    finally:
        gate.set()
        pi.shutdown()


def test_deadline_expiring_during_exec_surfaces_timeout():
    pnet = _net()
    pi = ParallelInference(pnet, mode=InferenceMode.BATCHED, workers=1,
                           max_batch_size=4, buckets=(4,), max_delay_ms=0.5)
    orig = pi._execute
    try:
        x = np.zeros((2, N_IN), np.float32)
        pi.output(x)
        pi._execute = lambda *a, **k: (time.sleep(0.12), orig(*a, **k))[1]
        fut = pi.submit(x, timeout_ms=50)
        with pytest.raises(ServingTimeoutError):
            fut.result(timeout=10)
        assert pi.metrics.counters["requests_timed_out"] == 1
        assert pi.metrics.timeout_causes.get("deadline") == 1
    finally:
        pi._execute = orig
        pi.shutdown()


@pytest.mark.parametrize("drain", [True, False])
def test_shutdown_drains_or_fails_pending(drain):
    pnet = _net()
    rng = np.random.default_rng(9)
    xs = [rng.normal(size=(2, N_IN)).astype(np.float32) for _ in range(40)]
    if drain:
        pi = ParallelInference(pnet, mode=InferenceMode.BATCHED, workers=2,
                               max_batch_size=16, max_delay_ms=1.0,
                               max_queue_len=128)
        futs = [pi.submit(x) for x in xs]
        pi.shutdown(drain=True)
        for x, f in zip(xs, futs):
            np.testing.assert_allclose(f.result(timeout=0), _direct(pnet, x),
                                       rtol=0, atol=TOL_OUTPUT["dense"])
    else:
        gate = threading.Event()
        pi = _one_row_server(pnet, max_queue_len=8)
        _gated(pi, gate)
        pi.submit(np.zeros((1, N_IN), np.float32))
        assert _wait_until(lambda: pi._queue.pending() == 0)
        pending = pi.submit(np.zeros((1, N_IN), np.float32))
        gate.set()
        pi.shutdown(drain=False)
        with pytest.raises(ServerClosedError):
            pending.result(timeout=10)
    with pytest.raises(ServerClosedError):
        pi.submit(xs[0])
    pi.shutdown()                   # idempotent


def test_slo_admission_sheds_doomed_requests():
    pnet = _net()
    gate = threading.Event()
    pi = ParallelInference(pnet, mode=InferenceMode.BATCHED, workers=1,
                           max_batch_size=4, buckets=(4,), max_queue_len=64,
                           max_delay_ms=0.5, resilience=True)
    _gated(pi, gate)
    try:
        for _ in range(pi.admission.min_samples):
            pi.admission.observe(50.0)
        first = pi.submit(np.zeros((4, N_IN), np.float32))
        assert _wait_until(lambda: pi._queue.pending() == 0)
        filler = pi.submit(np.zeros((4, N_IN), np.float32))
        # 4 queued rows + 1 own row -> 2 dispatches x 50 ms = 100 ms
        # estimated wait > the 20 ms deadline: shed at submit, typed
        with pytest.raises(ServerOverloadedError) as ei:
            pi.submit(np.zeros((1, N_IN), np.float32), timeout_ms=20)
        assert ei.value.retry_after_s > 0
        assert pi.metrics.counters["requests_shed"] == 1
        roomy = pi.submit(np.zeros((1, N_IN), np.float32),
                          timeout_ms=60_000)
        free = pi.submit(np.zeros((1, N_IN), np.float32))
        gate.set()
        for f in (first, filler, roomy, free):
            assert f.result(timeout=30) is not None
        assert pi.metrics.counters["requests_shed"] == 1
    finally:
        gate.set()
        pi.shutdown()


def test_warmup_counts_buckets_and_traffic_compiles_nothing_new():
    pnet = _net()
    with ParallelInference(pnet, mode=InferenceMode.BATCHED,
                           max_batch_size=8, max_delay_ms=1.0,
                           warmup_buckets=True) as pi:
        assert pi.warmup_report["buckets"] == list(pow2_buckets(8))
        assert pi.metrics.counters["warmup_compiles"] == len(
            pow2_buckets(8))
        rng = np.random.default_rng(4)
        for _ in range(10):
            pi.output(rng.normal(size=(int(rng.integers(1, 9)), N_IN))
                      .astype(np.float32))
        assert pi.metrics.counters["compiles"] == 0
        pi.warmup([8])              # a repeat on a live server adds none
        assert pi.metrics.counters["warmup_compiles"] == len(
            pow2_buckets(8))
    with ParallelInference(pnet, mode=InferenceMode.SEQUENTIAL,
                           max_batch_size=4) as pi:
        assert pi.warmup()["buckets"] == [1, 2, 4]
        pi.output(np.zeros((3, N_IN), np.float32))
        assert pi.metrics.counters["compiles"] == 1


# ---------------------------------------------------------------------------
# the resilience rail end to end


class _Die(BaseException):
    """Escapes the worker's Exception guard: worker death."""


def _failing_exec(pi, n, every):
    """Every ``every``-th exec raises, ``n`` times in all (the JAX
    package's ``ChaosMonkey.failing_exec``, whose ``faults/`` is not
    ported)."""
    state = {"calls": 0, "left": int(n)}
    orig = pi._execute

    def chaotic(features, real_rows=None):
        state["calls"] += 1
        if state["left"] > 0 and state["calls"] % every == 0:
            state["left"] -= 1
            raise RuntimeError(f"injected exec failure {state['calls']}")
        return orig(features, real_rows=real_rows)

    pi._execute = chaotic
    return state, orig


@pytest.mark.parametrize("model", ["dense", "resnet50"])
def test_poisoned_request_quarantined_healthy_bit_equal(pairs, model):
    _, pnet = _pair(pairs, model)
    bucket = MODELS[model][2] * 4       # the three and the poison in one
    xs = _requests(model, n=3, seed=4)
    pi = ParallelInference(pnet, mode=InferenceMode.BATCHED, workers=1,
                           max_batch_size=bucket, buckets=(bucket,),
                           max_delay_ms=200.0, resilience=True)
    try:
        solo = [pi.output(x) for x in xs]
        futs = [pi.submit(x) for x in xs]
        pf = pi.submit(np.full_like(xs[0], np.nan))
        with pytest.raises(PoisonedRequestError) as ei:
            pf.result(timeout=60)
        assert ei.value.request_id is not None
        for f, s in zip(futs, solo):
            assert np.array_equal(f.result(timeout=60), s)
        assert pi.metrics.counters["poisoned_quarantined"] == 1
        assert pi.metrics.counters["bisect_splits"] >= 1
        assert pi.breaker.state == "closed"
    finally:
        pi.shutdown()


def test_transient_exec_faults_absorbed_zero_healthy_failures():
    pnet = _net()
    pi = ParallelInference(pnet, mode=InferenceMode.BATCHED, workers=2,
                           max_batch_size=8, max_delay_ms=1.0,
                           max_queue_len=512, resilience=True)
    try:
        state, _ = _failing_exec(pi, n=6, every=5)
        lg = LoadGenerator(
            pi, lambda rng, i: rng.normal(size=(2, N_IN))
            .astype(np.float32), seed=2)
        res = lg.run_closed(n_requests=96, concurrency=4)
        assert state["left"] == 0, "injector never fired fully"
        assert (res.n_failed, res.n_timed_out, res.n_rejected) == (0, 0, 0)
        assert res.n_ok == 96
        assert pi.metrics.counters["exec_faults"] >= 6
        assert pi.metrics.counters["poisoned_quarantined"] == 0
    finally:
        pi.shutdown()


def test_breaker_opens_sheds_and_heals():
    pnet = _net()
    cfg = ResilienceConfig(breaker_failure_threshold=3,
                           breaker_reset_s=0.5, single_retries=0,
                           admission=False)
    pi = ParallelInference(pnet, mode=InferenceMode.BATCHED, workers=1,
                           max_batch_size=4, buckets=(4,),
                           max_delay_ms=0.5, resilience=cfg)
    try:
        x = np.zeros((1, N_IN), np.float32)
        state, orig = _failing_exec(pi, n=3, every=1)
        for _ in range(3):
            with pytest.raises(ServingError):
                pi.submit(x).result(timeout=30)
        assert pi.breaker.state == "open"
        with pytest.raises(ServerOverloadedError) as ei:
            pi.submit(x)            # open: shed with the backoff hint
        assert 0 < ei.value.retry_after_s <= 0.5
        assert pi.metrics.counters["requests_shed"] == 1
        assert pi.metrics.counters["breaker_opens"] == 1
        assert pi.metrics.resilience["breaker_state"] == "open"
        assert _wait_until(lambda: pi.breaker.reject_for() is None,
                           timeout=5)
        assert pi.submit(x).result(timeout=30) is not None
        assert _wait_until(lambda: pi.breaker.state == "closed", timeout=10)
        assert pi.metrics.resilience["breaker_state"] == "closed"
    finally:
        pi._execute = orig
        pi.shutdown()


@pytest.mark.parametrize("kills", [1, 2])
def test_worker_crash_requeued_exactly_once(kills):
    pnet = _net()
    cfg = ResilienceConfig(worker_backoff_base_s=0.01,
                           worker_backoff_max_s=0.05)
    pi = ParallelInference(pnet, mode=InferenceMode.BATCHED, workers=1,
                           max_batch_size=4, max_delay_ms=1.0,
                           resilience=cfg)
    orig = pi._execute
    try:
        state = {"kills": kills}

        def killer(features, real_rows=None):
            if state["kills"] > 0:
                state["kills"] -= 1
                raise _Die("worker death mid-dispatch")
            return orig(features, real_rows=real_rows)

        pi._execute = killer
        x = np.random.default_rng(0).normal(size=(2, N_IN)) \
            .astype(np.float32)
        fut = pi.submit(x)
        if kills == 1:
            np.testing.assert_allclose(fut.result(timeout=60),
                                       _direct(pnet, x), rtol=0,
                                       atol=TOL_OUTPUT["dense"])
        else:
            with pytest.raises(ServingError, match="twice"):
                fut.result(timeout=60)
        assert pi.metrics.counters["worker_restarts"] >= kills
        assert pi.metrics.counters["requests_requeued"] == 1
        np.testing.assert_allclose(pi.output(x), _direct(pnet, x), rtol=0,
                                   atol=TOL_OUTPUT["dense"])
    finally:
        pi._execute = orig
        pi.shutdown()


def test_persistent_guard_errors_escalate_to_worker_restart():
    pnet = _net()
    cfg = ResilienceConfig(worker_max_consecutive_errors=3,
                           worker_backoff_base_s=0.01,
                           worker_backoff_max_s=0.05)
    pi = ParallelInference(pnet, mode=InferenceMode.BATCHED, workers=1,
                           max_delay_ms=0.5, resilience=cfg)
    try:
        state = {"left": 4}
        orig = pi._batcher.next_batch

        def flaky(poll_timeout=0.1):
            if state["left"] > 0:
                state["left"] -= 1
                raise RuntimeError("persistent loop bug")
            return orig(poll_timeout=poll_timeout)

        pi._batcher.next_batch = flaky
        assert _wait_until(
            lambda: pi.metrics.counters["worker_restarts"] >= 1,
            timeout=20)
        x = np.zeros((2, N_IN), np.float32)
        np.testing.assert_allclose(pi.output(x), _direct(pnet, x), rtol=0,
                                   atol=TOL_OUTPUT["dense"])
    finally:
        pi.shutdown()


@pytest.mark.parametrize("how", ["worker_death", "guard_error"])
def test_half_open_probe_is_released_when_its_holder_fails(how):
    pnet = _net()
    cfg = ResilienceConfig(breaker_failure_threshold=1,
                           breaker_reset_s=0.2, single_retries=0,
                           worker_backoff_base_s=0.01,
                           worker_backoff_max_s=0.05)
    pi = ParallelInference(pnet, mode=InferenceMode.BATCHED, workers=1,
                           max_batch_size=4, buckets=(4,),
                           max_delay_ms=0.5, resilience=cfg)
    x = np.zeros((1, N_IN), np.float32)
    state, orig = _failing_exec(pi, n=1, every=1)
    try:
        with pytest.raises(ServingError):
            pi.submit(x).result(timeout=30)     # opens the breaker
        assert pi.breaker.state == "open"
        fired = {"left": 1}
        if how == "worker_death":
            def killer(features, real_rows=None):
                if fired["left"] > 0:
                    fired["left"] -= 1
                    raise _Die("probe-owning worker death")
                return orig(features, real_rows=real_rows)
            pi._execute = killer
        else:
            pi._execute = orig
            nb = pi._batcher.next_batch

            def flaky(poll_timeout=0.1):
                if fired["left"] > 0 and pi.breaker.state == "half_open":
                    fired["left"] -= 1
                    raise RuntimeError("guard error holding the probe")
                return nb(poll_timeout=poll_timeout)
            pi._batcher.next_batch = flaky
        assert _wait_until(lambda: pi.breaker.reject_for() is None,
                           timeout=5)
        assert pi.submit(x).result(timeout=60) is not None
        assert fired["left"] == 0, "injector never fired"
        assert _wait_until(lambda: pi.breaker.state == "closed", timeout=30)
    finally:
        pi._execute = orig
        pi.shutdown()


def test_bisection_of_one_raising_request_does_not_open_breaker():
    pnet = _net()
    cfg = ResilienceConfig(breaker_failure_threshold=3,
                           breaker_reset_s=60.0, single_retries=1)
    pi = ParallelInference(pnet, mode=InferenceMode.BATCHED, workers=1,
                           max_batch_size=8, buckets=(8,),
                           max_delay_ms=100.0, resilience=cfg)
    orig = pi._execute
    try:
        def nan_raises(features, real_rows=None):
            if np.isnan(np.asarray(features[0])).any():
                raise RuntimeError("exec rejects this batch")
            return orig(features, real_rows=real_rows)

        rng = np.random.default_rng(8)
        xs = [rng.normal(size=(1, N_IN)).astype(np.float32)
              for _ in range(3)]
        solo = [pi.output(x) for x in xs]
        pi._execute = nan_raises
        futs = [pi.submit(x) for x in xs]
        pf = pi.submit(np.full((1, N_IN), np.nan, np.float32))
        with pytest.raises(PoisonedRequestError):
            pf.result(timeout=60)
        for f, s in zip(futs, solo):
            assert np.array_equal(f.result(timeout=60), s)
        assert pi.breaker.state == "closed"
        assert pi.metrics.counters["breaker_opens"] == 0
    finally:
        pi._execute = orig
        pi.shutdown()


def test_many_workers_each_future_gets_its_own_rows():
    """More workers than cores, a short switch interval: every future
    resolves to its own request's rows (a lost update in the queue, the
    batcher or the scatter would hand one request another's answer)."""
    pnet = _net()
    rng = np.random.default_rng(12)
    xs = [rng.normal(size=(int(rng.integers(1, 4)), N_IN))
          .astype(np.float32) for _ in range(200)]
    want = [_direct(pnet, x) for x in xs]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ParallelInference(pnet, mode=InferenceMode.BATCHED, workers=8,
                               max_batch_size=16, max_delay_ms=0.5,
                               max_queue_len=512, resilience=True) as pi:
            futs = [pi.submit(x) for x in xs]
            got = [f.result(timeout=60) for f in futs]
    finally:
        sys.setswitchinterval(old)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL_OUTPUT["dense"])
    assert pi.metrics.counters["requests_served"] == 200
    assert pi.metrics.counters["rows_served"] == sum(len(x) for x in xs)


# ---------------------------------------------------------------------------
# load generator


@pytest.mark.parametrize("loop", ["closed", "open"])
def test_loadgen_loops(loop):
    pnet = _net()
    with ParallelInference(pnet, mode=InferenceMode.BATCHED,
                           max_delay_ms=1.0, max_queue_len=64) as pi:
        lg = LoadGenerator(
            pi, lambda rng, i: rng.normal(size=(2, N_IN))
            .astype(np.float32), seed=0)
        if loop == "closed":
            res = lg.run_closed(n_requests=24, concurrency=3)
            assert res.n_ok == 24 and res.n_issued == 24
            assert len(res.latencies_ms) == 24
        else:
            res = lg.run_open(n_requests=16, rate_rps=400.0)
            assert res.n_ok + res.n_rejected + res.n_timed_out == 16
            assert res.n_ok > 0
    assert res.throughput_rps > 0
    assert res.percentile(50) <= res.percentile(99)
    assert "LoadResult" in res.stats()
    assert pi.metrics.counters["requests_served"] == res.n_ok


def test_loadgen_requests_follow_the_seeded_generators_as_jax():
    """The same request function sees the same generator draws in both
    packages' closed loops (one client: thread 0's ``seed + 0``)."""
    seen = {}
    for pkg in (serving, jserving):
        calls = []

        class Echo:
            def output(self, x, timeout_ms=None):
                return x

        def fn(rng, i, calls=calls):
            x = rng.normal(size=(1, N_IN))
            calls.append((i, x))
            return x
        pkg.LoadGenerator(Echo(), fn, seed=5).run_closed(4, concurrency=1)
        seen[pkg.__name__] = calls
    port, jax_ = seen.values()
    assert [i for i, _ in port] == [i for i, _ in jax_] == [0, 1, 2, 3]
    for (_, a), (_, b) in zip(port, jax_):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# refusals name their queue items


@pytest.mark.parametrize("kwargs,item", [
    ({"telemetry_port": 0}, "item 2.5"),
    ({"stats_storage": object()}, "item 2.8"),
    ({"profile_dir": "prof"}, "item 7: profiler/"),
    ({"analyze": True}, "item 7: analyze/"),
    ({"analyze": "strict"}, "item 7: analyze/")])
def test_parallel_inference_refuses_what_is_not_ported_by_name(kwargs, item):
    with pytest.raises(NotImplementedError, match=f"queue 1 {item}"):
        ParallelInference(_net(), mode=InferenceMode.INPLACE, **kwargs)


def test_reload_from_is_refused_by_name():
    with ParallelInference(_net(), mode=InferenceMode.INPLACE) as pi:
        with pytest.raises(NotImplementedError,
                           match="queue 1 item 7: checkpoint/"):
            pi.reload_from(None)
        assert pi.memory_sample_every == 64


def _refusal(kind):
    from deeplearning4j_tpu_torch.kernels import attention
    from deeplearning4j_tpu_torch.learning.updaters import IUpdater
    from deeplearning4j_tpu_torch.nn import (GlobalPoolingLayer,
                                             SubsamplingLayer)
    if kind == "schedule":
        # schedules are ported; a JAX updater's JSON the port lacks is not
        return lambda: IUpdater.from_json(
            {"@class": "AdaMax", "learning_rate": {
                "@class": "ExponentialSchedule", "initial_value": 0.1,
                "gamma": 0.9, "schedule_type": "ITERATION"}})
    if kind == "pnorm_pooling":
        conf = (NeuralNetConfiguration.builder().list()
                .layer(SubsamplingLayer(pooling_type="PNORM"))
                .layer(OutputLayer(n_out=2))
                .set_input_type(InputType.convolutional(4, 4, 1)).build())
        return lambda: MultiLayerNetwork(conf).init(device="cpu")
    if kind == "center_loss_in_mln":
        from deeplearning4j_tpu_torch.nn import CenterLossOutputLayer
        conf = (NeuralNetConfiguration.builder().list()
                .layer(CenterLossOutputLayer(n_out=2))
                .set_input_type(InputType.feed_forward(3)).build())
        return lambda: MultiLayerNetwork(conf).init(device="cpu")
    if kind == "layer_json":
        from deeplearning4j_tpu_torch.nn.layers import BaseLayer
        return lambda: BaseLayer.from_json({"@class":
                                            "VariationalAutoencoderLayer",
                                            "n_out": 4})

    def graph(layer):
        conf = (NeuralNetConfiguration.builder().graph_builder()
                .add_inputs("in")
                .set_input_types(InputType.convolutional(4, 4, 1))
                .add_layer("l", layer, "in")
                .add_layer("out", OutputLayer(n_out=2), "l")
                .set_outputs("out").build())
        return lambda: ComputationGraph(conf).init(device="cpu")
    if kind == "graph_subsampling":
        return graph(SubsamplingLayer(pooling_type="PNORM"))
    if kind == "global_pooling":
        return graph(GlobalPoolingLayer(pooling_type="PNORM"))
    assert kind == "masked_attention"

    class CardTensor(torch.Tensor):
        """A CPU tensor that reports a CUDA device."""
        @property
        def device(self):
            return torch.device("cuda")
    q = torch.zeros(1, 1, 2, 4).as_subclass(CardTensor)
    return lambda: attention.scaled_dot_product_attention(
        q, q, q, mask=torch.ones(2, 2, dtype=torch.bool))


@pytest.mark.parametrize("kind,item", [
    ("schedule", "queue 1 item 3"),
    ("pnorm_pooling", "queue 1 item 5"),
    ("center_loss_in_mln", "queue 1 item 10"),
    ("layer_json", "queue 1 item 10"),
    ("graph_subsampling", "queue 1 item 5"),
    ("global_pooling", "queue 1 item 5"),
    ("masked_attention", "queue 2b item 8")])
def test_refusals_name_their_queue_items(kind, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        _refusal(kind)()
