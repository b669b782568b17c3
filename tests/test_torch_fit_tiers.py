"""SameDiff's fit tiers in the port, on the CPU.

The port's fused windows (K = 4 and 8, ragged tails of 3 and 5 steps)
and its scanned epoch against its per-step tier, and its windowed fit
against the JAX package's, from the same weights and batches. On the CPU
a window runs its steps eagerly, so the tiers of the port run the same
arithmetic; the JAX tier tolerance (``tests/test_fused_windows.py``:
rtol 1e-5, atol 1e-6) holds every parameter and every step's loss.
Also: ``pow2_buckets`` against the JAX function, the listeners' burst
delivery (which iterations, which losses, how many calls a flush) against
the JAX fit's, ``iteration_count`` and ``last_fit_stats`` after each
tier, and the stored arrays a captured window reads.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.autodiff import Listener as JListener
from deeplearning4j_tpu.autodiff.window import pow2_buckets as jpow2_buckets
from deeplearning4j_tpu.learning.updaters import Adam as JAdam
from deeplearning4j_tpu.nn import DenseLayer as JDense
from deeplearning4j_tpu.nn import InputType as JInputType
from deeplearning4j_tpu.nn import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn import OutputLayer as JOutput
from deeplearning4j_tpu_torch.autodiff import (Listener,
                                               ScoreIterationListener)
from deeplearning4j_tpu_torch.autodiff.window import pow2_buckets
from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
from deeplearning4j_tpu_torch.learning import Adam
from deeplearning4j_tpu_torch.nn import (DenseLayer, InputType,
                                         MultiLayerNetwork,
                                         NeuralNetConfiguration, OutputLayer)
from deeplearning4j_tpu_torch.zoo import LeNet

BATCH, FEATS, CLASSES = 8, 12, 4
RTOL, ATOL = 1e-5, 1e-6


def _conf(pkg):
    nnc, dense, out, itype, adam = {
        "port": (NeuralNetConfiguration, DenseLayer, OutputLayer, InputType,
                 Adam),
        "jax": (JNNC, JDense, JOutput, JInputType, JAdam)}[pkg]
    return (nnc.builder().seed(7).updater(adam(learning_rate=1e-2)).list()
            .layer(dense(n_out=16, activation="relu"))
            .layer(out(n_out=CLASSES, loss_function="MCXENT"))
            .set_input_type(itype.feed_forward(FEATS)).build())


def _data(steps, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(steps * BATCH, FEATS)).astype(np.float32)
    y = np.eye(CLASSES, dtype=np.float32)[
        rng.integers(0, CLASSES, steps * BATCH)]
    return x, y


class _Stream:
    """Host batches, no ``stacked_batches``."""

    def __init__(self, x, y, batch=BATCH):
        self.x, self.y, self.batch = x, y, batch

    def __iter__(self):
        for i in range(0, len(self.x), self.batch):
            yield self.x[i:i + self.batch], self.y[i:i + self.batch]


def _recorder(base, frequency):
    class Rec(base):
        def __init__(self):
            self.frequency = frequency
            self.calls = []

        def iterations_done(self, sd, epoch, iterations, losses):
            self.calls.append((epoch, list(iterations),
                               [float(v) for v in losses]))
    return Rec()


def _losses(rec):
    return [v for _, _, vals in rec.calls for v in vals]


def _port_fit(steps, k, source, epochs=2, listener=True, net=None):
    x, y = _data(steps)
    net = net or MultiLayerNetwork(_conf("port")).init(device="cpu")
    rec = _recorder(Listener, 10 ** 9)
    it = DeviceCachedIterator(x, y, BATCH, device="cpu") \
        if source == "cached" else _Stream(x, y)
    hist = net.fit(it, epochs=epochs, listeners=[rec] if listener else [],
                   fused_steps=k)
    return net, rec, hist


def _close(got, want):
    for name, a in want.items():
        np.testing.assert_allclose(got[name], a, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def test_pow2_buckets_match_jax():
    for r in range(0, 70):
        assert pow2_buckets(r) == jpow2_buckets(r), r


@pytest.mark.parametrize("source", ["cached", "stream"])
@pytest.mark.parametrize("k,steps,sizes", [
    (4, 11, {4: 2, 2: 1, 1: 1}), (8, 13, {8: 1, 4: 1, 1: 1}),
    (8, 16, {8: 2})])
def test_windows_match_the_per_step_tier(k, steps, sizes, source):
    ref, ref_rec, ref_hist = _port_fit(steps, 1, source)
    assert ref.samediff.last_fit_stats["tier"] == "per_step"
    net, rec, hist = _port_fit(steps, k, source)
    st = net.samediff.last_fit_stats
    assert st["tier"] == "windowed" and st["window_sizes"] == sizes
    assert st["dispatches_per_epoch"] == sum(sizes.values())
    assert st["steps_per_epoch"] == steps and st["eager_steps_per_epoch"] == 0
    assert st["window_captures"] == 0     # the second epoch's: none new
    _close(net.params(), ref.params())
    np.testing.assert_allclose(_losses(rec), _losses(ref_rec), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(hist.step_losses, ref_hist.step_losses,
                               rtol=RTOL, atol=ATOL)
    for n in (net, ref):
        tc = n.samediff.training_config
        assert (tc.iteration_count, tc.epoch_count) == (2 * steps, 2)


@pytest.mark.parametrize("steps", [1, 11])
def test_scanned_epoch_matches_the_per_step_tier(steps):
    ref, ref_rec, _ = _port_fit(steps, 1, "cached")
    net, _, hist = _port_fit(steps, 1, "cached", listener=False)
    st = net.samediff.last_fit_stats
    assert st["tier"] == "scanned_epoch" and st["window_sizes"] == {steps: 1}
    assert st["dispatches_per_epoch"] == 1
    assert st["graph_replays_per_epoch"] == 0          # the CPU: eager
    _close(net.params(), ref.params())
    np.testing.assert_allclose(hist.step_losses, _losses(ref_rec),
                               rtol=RTOL, atol=ATOL)
    assert len(hist.epoch_losses) == 2
    assert net.samediff.training_config.iteration_count == 2 * steps


def test_a_ragged_final_batch_is_one_eager_step():
    x, y = _data(11)
    x, y = x[:-3], y[:-3]                          # 10 full batches + 5 rows
    ref = MultiLayerNetwork(_conf("port")).init(device="cpu")
    ref.fit(_Stream(x, y), listeners=[_recorder(Listener, 10 ** 9)])
    net = MultiLayerNetwork(_conf("port")).init(device="cpu")
    net.fit(_Stream(x, y), fused_steps=4)
    st = net.samediff.last_fit_stats
    assert st["window_sizes"] == {4: 2, 2: 1, 1: 1}
    assert st["eager_steps_per_epoch"] == 1 and st["steps_per_epoch"] == 11
    _close(net.params(), ref.params())


@pytest.mark.parametrize("k,steps", [(4, 11), (8, 13)])
def test_windows_match_the_jax_windowed_fit(k, steps):
    """The same weights (the same seed's draws) and batches through both
    packages' windowed fits: every step's loss and every parameter."""
    x, y = _data(steps)
    jnet = JMLN(_conf("jax")).init()
    jrec = _recorder(JListener, 10 ** 9)
    jnet.fit(_Stream(x, y), epochs=2, listeners=[jrec], fused_steps=k)
    assert jnet.samediff.last_fit_stats["tier"] == "windowed"
    net, rec, _ = _port_fit(steps, k, "stream")
    np.testing.assert_allclose(_losses(rec), _losses(jrec), rtol=RTOL,
                               atol=ATOL)
    _close(net.params(), jnet.params())
    jst, st = jnet.samediff.last_fit_stats, net.samediff.last_fit_stats
    for key in ("steps_per_epoch", "dispatches_per_epoch", "window_sizes"):
        assert st[key] == jst[key], key
    assert net.samediff.training_config.iteration_count == \
        jnet.samediff.training_config.iteration_count


@pytest.mark.parametrize("k,frequency", [(1, 5), (4, 5), (8, 3), (4, 4)])
def test_listener_bursts_match_jax(k, frequency):
    """A listener gets the same iterations and losses, in the same calls
    (one a flush: at the first window boundary at or after each multiple
    of its frequency, and at an epoch's end), as from the JAX fit."""
    x, y = _data(11)
    jnet = JMLN(_conf("jax")).init()
    jrec = _recorder(JListener, frequency)
    jnet.fit(_Stream(x, y), epochs=2, listeners=[jrec], fused_steps=k)
    net = MultiLayerNetwork(_conf("port")).init(device="cpu")
    rec = _recorder(Listener, frequency)
    net.fit(_Stream(x, y), epochs=2, listeners=[rec], fused_steps=k)
    assert [(e, its) for e, its, _ in rec.calls] == \
        [(e, its) for e, its, _ in jrec.calls]
    np.testing.assert_allclose(_losses(rec), _losses(jrec), rtol=RTOL,
                               atol=ATOL)


def test_score_listener_prints_the_iterations_it_is_asked_for():
    printed = []
    net = MultiLayerNetwork(_conf("port")).init(device="cpu")
    x, y = _data(11)
    net.fit(DeviceCachedIterator(x, y, BATCH, device="cpu"), epochs=2,
            listeners=[ScoreIterationListener(4, printed.append)],
            fused_steps=8)
    assert [p.split()[3] for p in printed] == ["0", "4", "8", "12", "16",
                                               "20"]
    assert all(p.startswith("Score at iteration ") for p in printed)


def test_epoch_end_false_stops_the_fit():
    class Stop(Listener):
        def on_epoch_end(self, sd, epoch, mean_loss):
            return epoch < 1

    net = MultiLayerNetwork(_conf("port")).init(device="cpu")
    x, y = _data(5)
    hist = net.fit(DeviceCachedIterator(x, y, BATCH, device="cpu"),
                   epochs=5, listeners=[Stop()], fused_steps=2)
    assert len(hist.epoch_losses) == 2
    assert net.samediff.training_config.iteration_count == 10


def test_lenet_windows_match_its_per_step_tier():
    """LeNet at full width, batch 8: 6 steps a epoch, windows of 4 and 2."""
    rng = np.random.default_rng(0)
    x = rng.random((48, 1, 28, 28)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 48)]
    nets = {}
    for k in (1, 4):
        net = LeNet().build(device="cpu")
        rec = _recorder(Listener, 10 ** 9)
        net.fit(DeviceCachedIterator(x, y, 8, device="cpu"), epochs=1,
                listeners=[rec], fused_steps=k)
        nets[k] = (net, rec)
    assert nets[4][0].samediff.last_fit_stats["window_sizes"] == {4: 1, 2: 1}
    _close(nets[4][0].params(), nets[1][0].params())
    np.testing.assert_allclose(_losses(nets[4][1]), _losses(nets[1][1]),
                               rtol=RTOL, atol=ATOL)


def test_set_arr_for_var_writes_into_the_stored_tensor():
    """A set writes a new stored tensor, as the JAX package does: what
    get_arr_for_var returned before keeps its values (``old = get(n);
    set(n, old + 1)`` leaves ``old`` as it was, and ``set(n, old)``
    restores it). The captured windows, which read the old tensor, are
    dropped, and the next fit captures its windows again."""
    net, _, _ = _port_fit(4, 2, "cached", epochs=1)
    sd = net.samediff
    assert sd._windows
    name = "layer0_dense_W"
    old = sd.get_arr_for_var(name)
    kept = old.clone()
    sd.set_arr_for_var(name, old + 1)
    assert torch.equal(old, kept)
    assert torch.equal(sd.get_arr_for_var(name), kept + 1)
    assert not sd._windows
    sd.set_arr_for_var(name, old)
    assert torch.equal(sd.get_arr_for_var(name), kept)
    assert sd.get_arr_for_var(name).data_ptr() != old.data_ptr()
    net.set_param(name, np.zeros(tuple(old.shape), np.float64))
    assert sd._arrays[name].dtype == torch.float64
    net.set_param(name, kept.numpy())
    _port_fit(4, 2, "cached", epochs=1, net=net)
    assert sd.last_fit_stats["window_captures"] == 1 and len(sd._windows) == 1


def test_set_param_between_fits_is_seen_by_the_next_window():
    """Two nets, windowed and per-step, from one start: the same
    set_param between two fits keeps them equal."""
    nets = []
    for k in (4, 1):
        net, _, _ = _port_fit(6, k, "cached", epochs=1)
        w = net.params()["layer0_dense_W"]
        net.set_param("layer0_dense_W", 0.5 * w)
        _port_fit(6, k, "cached", epochs=1, net=net)
        nets.append(net)
    _close(nets[0].params(), nets[1].params())


def test_a_window_counts_its_launches_at_each_replay(monkeypatch):
    """A capture records the wrappers' calls without launching: what the
    recording added to the counters is taken back out, and each replay
    adds it again."""
    import types

    from deeplearning4j_tpu_torch.autodiff.window import StepWindow
    from deeplearning4j_tpu_torch.kernels import _cuda
    counter = {"kernel": 0, "copy": 0}
    monkeypatch.setattr(_cuda, "COUNTERS", _cuda.COUNTERS + [counter])
    snap = _cuda.count_snapshot()
    counter["kernel"] += 3                      # a recording's calls
    counts = _cuda.counts_since(snap)
    assert counts == [(counter, "kernel", 3)]
    _cuda.add_counts(counts, -1)
    assert counter == {"kernel": 0, "copy": 0}
    win = StepWindow.__new__(StepWindow)
    win.graph = types.SimpleNamespace(replay=lambda: None)
    win.counts = counts
    win.run()
    win.run()
    assert counter == {"kernel": 6, "copy": 0}


def test_the_scanned_window_outlives_a_cast_of_the_data():
    """float32 batches into a float64 network: the cast copy of the
    iterator's tensors is kept, so a second fit over the same iterator
    makes no new window, and it reads the data as it is now (an edit of
    the iterator's tensors between fits reaches it)."""
    def conf():
        return (NeuralNetConfiguration.builder().seed(7).data_type("float64")
                .updater(Adam(learning_rate=1e-2)).list()
                .layer(DenseLayer(n_out=16, activation="relu"))
                .layer(OutputLayer(n_out=CLASSES, loss_function="MCXENT"))
                .set_input_type(InputType.feed_forward(FEATS)).build())
    x, y = _data(4)
    nets = []
    for listeners in ([], [_recorder(Listener, 10 ** 9)]):
        it = DeviceCachedIterator(x.copy(), y, BATCH, device="cpu")
        net = MultiLayerNetwork(conf()).init(device="cpu")
        net.fit(it, epochs=1, listeners=listeners)
        feats, _ = it.stacked_batches()
        feats[0].mul_(-1.0)
        net.fit(it, epochs=1, listeners=listeners)
        nets.append(net)
    sd = nets[0].samediff
    assert sd.last_fit_stats["tier"] == "scanned_epoch"
    assert sd.last_fit_stats["window_captures"] == 0
    assert sd._bound[2]["input"].dtype == torch.float64
    _close(nets[0].params(), nets[1].params())
