"""The port's checkpoints against ``deeplearning4j_tpu.checkpoint``.

A checkpoint written by the JAX ``CheckpointManager`` restores in the
port and one written by the port restores in the JAX package, for a
SameDiff MLP (Adam) and a small ``ComputationGraph`` with a batch norm
(Nesterovs; convolution weights HWIO on disk, OIHW in the port): the
arrays and updater leaves by name, layout and order, then both packages
continue 4 steps from the restored state and agree within the JAX tier
tolerance (rtol 1e-5 / atol 1e-6). Then the commit protocol (torn and
uncommitted directories refused and collected as the JAX manager
refuses and collects them, retention, sticky writer errors), the
``CheckpointListener`` cadence, a bit-exact resume, and a restore that
copies into the live tensors (no window is captured again)."""
import json
import os

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.checkpoint as jck
import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu_torch.checkpoint as pck
import deeplearning4j_tpu_torch.nn as pnn
from deeplearning4j_tpu.autodiff import Listener as JListener
from deeplearning4j_tpu.autodiff import SameDiff as JSameDiff
from deeplearning4j_tpu.autodiff import TrainingConfig as JTrainingConfig
from deeplearning4j_tpu.dataset import DeviceCachedIterator as JIterator
from deeplearning4j_tpu.learning import updaters as jup
from deeplearning4j_tpu_torch.autodiff import (Listener, SameDiff,
                                               TrainingConfig)
from deeplearning4j_tpu_torch.convert import params_from_jax
from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
from deeplearning4j_tpu_torch.learning import updaters as pup

RTOL, ATOL = 1e-5, 1e-6
FEATS, CLASSES, B = 12, 4, 8


def _mlp(pkg):
    rng = np.random.default_rng(0)
    sd = JSameDiff() if pkg == "jax" else SameDiff(device="cpu")
    x = sd.placeholder("x", shape=(-1, FEATS))
    w0 = sd.var("w0", value=rng.normal(0, .3, (FEATS, 16)).astype(
        np.float32))
    b0 = sd.var("b0", value=np.zeros(16, np.float32))
    h = sd.nn.relu(x.mmul(w0).add(b0))
    w1 = sd.var("w1", value=rng.normal(0, .3, (16, CLASSES)).astype(
        np.float32))
    labels = sd.placeholder("labels", shape=(-1, CLASSES))
    sd.loss.softmax_cross_entropy(h.mmul(w1), labels, name="loss")
    sd.set_loss_variables(["loss"])
    tc = JTrainingConfig if pkg == "jax" else TrainingConfig
    m = jup if pkg == "jax" else pup
    sd.training_config = tc(updater=m.Adam(learning_rate=1e-2),
                            data_set_feature_mapping=["x"],
                            data_set_label_mapping=["labels"],
                            fused_steps=2)
    return sd


def _data(steps, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(steps * B, FEATS)).astype(np.float32)
    y = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES,
                                                        steps * B)]
    return x, y


def _iter(pkg, x, y):
    return JIterator(x, y, batch_size=B) if pkg == "jax" else \
        DeviceCachedIterator(x, y, batch_size=B, device="cpu")


def _arrays(pkg, sd):
    return {k: np.asarray(v) if pkg == "jax" else v.numpy().copy()
            for k, v in sd.trainable_params().items()}


def _quiet(base):
    class Q(base):
        frequency = 10 ** 9
    return Q()


def _close(got, want, rtol=RTOL, atol=ATOL):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_samediff_checkpoint_crosses_and_both_continue(writer, tmp_path):
    reader = "port" if writer == "jax" else "jax"
    mods = {"jax": jck, "port": pck}
    src = _mlp(writer)
    x, y = _data(3, seed=1)
    src.fit(_iter(writer, x, y), epochs=1, listeners=[_quiet(
        JListener if writer == "jax" else Listener)])
    mgr = mods[writer].CheckpointManager(tmp_path, async_write=False)
    mgr.save(3, model=src, epoch=1)
    mgr.close()
    files = sorted(os.listdir(tmp_path / "step_00000003"))
    assert files == ["COMMIT", "MANIFEST.json", "arrays.npz", "state.json",
                     "updater.npz"]
    dst = _mlp(reader)
    rmgr = mods[reader].CheckpointManager(tmp_path)
    step, state = rmgr.restore_latest(model=dst)
    assert step == 3 and state.iteration == 3 and state.epoch == 1
    assert dst.training_config.iteration_count == 3
    assert len(state.updater_leaves) == 6          # (m, v) for 3 names
    _close(_arrays(reader, dst), _arrays(writer, src), rtol=0, atol=0)
    # both continue 4 steps from the same state
    x2, y2 = _data(4, seed=2)
    for pkg, sd in ((writer, src), (reader, dst)):
        sd.fit(_iter(pkg, x2, y2), epochs=1, listeners=[_quiet(
            JListener if pkg == "jax" else Listener)])
        assert sd.training_config.iteration_count == 7
    _close(_arrays("port", dst if reader == "port" else src),
           _arrays("jax", dst if reader == "jax" else src))
    rmgr.close()


def _graph_conf(m, nesterovs):
    return (m.NeuralNetConfiguration.builder().seed(5).updater(nesterovs)
            .graph_builder().add_inputs("input")
            .set_input_types(m.InputType.convolutional(6, 6, 2))
            .add_layer("conv", m.ConvolutionLayer(
                n_out=4, kernel_size=(3, 3), convolution_mode="SAME"),
                "input")
            .add_layer("bn", m.BatchNormalization(), "conv")
            .add_layer("act", m.ActivationLayer(activation="relu"), "bn")
            .add_layer("gap", m.GlobalPoolingLayer(pooling_type="AVG"),
                       "act")
            .add_layer("output", m.OutputLayer(n_out=3,
                                               loss_function="MCXENT"),
                       "gap")
            .set_outputs("output").build())


def _graph(pkg, weights=None):
    if pkg == "jax":
        conf = _graph_conf(jnn, jup.Nesterovs(learning_rate=0.05,
                                              momentum=0.9))
        conf.cnn_data_format = "NCHW"
        return jnn.ComputationGraph(conf).init()
    net = pnn.ComputationGraph(_graph_conf(pnn, pup.Nesterovs(
        learning_rate=0.05, momentum=0.9))).init(device="cpu")
    if weights is not None:
        net.model.load_state_dict(params_from_jax(weights))
    return net


def _graph_data(steps, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(steps * B, 2, 6, 6)).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[rng.integers(0, 3, steps * B)]


def _gparams(pkg, net):
    return {k: np.asarray(v) for k, v in net.params().items()}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_graph_checkpoint_crosses_and_both_continue(writer, tmp_path):
    reader = "port" if writer == "jax" else "jax"
    jnet = _graph("jax")
    nets = {"jax": jnet, "port": _graph("port", jnet.params())}
    x, y = _graph_data(3, seed=1)
    src = nets[writer]
    src.fit(_iter(writer, x, y), epochs=1, fused_steps=2)
    mods = {"jax": jck, "port": pck}
    mgr = mods[writer].CheckpointManager(tmp_path, async_write=False)
    mgr.save(3, model=src, epoch=1)
    mgr.close()
    with np.load(tmp_path / "step_00000003" / "arrays.npz") as npz:
        assert npz["conv_W"].shape == (3, 3, 2, 4)          # HWIO
        assert {"bn_mean", "bn_var", "bn_gamma", "output_W"} <= \
            set(npz.files)
    fresh = _graph("jax")
    dst = fresh if reader == "jax" else _graph("port", fresh.params())
    step, state = mods[reader].CheckpointManager(tmp_path).restore_latest(
        model=dst)
    assert step == 3
    _close(_gparams(reader, dst), _gparams(writer, src), rtol=0, atol=0)
    x2, y2 = _graph_data(4, seed=2)
    for pkg, net in ((writer, src), (reader, dst)):
        net.fit(_iter(pkg, x2, y2), epochs=1, fused_steps=2)
    _close(_gparams("port", dst if reader == "port" else src),
           _gparams("jax", dst if reader == "jax" else src))


def test_updater_leaves_follow_the_jax_flattening_order(tmp_path):
    """Sorted JAX names, each name's leaves in order, HWIO layouts: the
    leaves the JAX package flattens from its ``{name: (v,)}``."""
    jnet = _graph("jax")
    pnet = _graph("port", jnet.params())
    x, y = _graph_data(2, seed=3)
    jnet.fit(JIterator(x, y, batch_size=B))
    pnet.fit(DeviceCachedIterator(x, y, batch_size=B, device="cpu"))
    js = jck.capture_training_state(jnet)
    ps = pck.capture_training_state(pnet)
    assert len(js.updater_leaves) == len(ps.updater_leaves)
    for a, b in zip(js.updater_leaves, ps.updater_leaves):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-5, atol=1e-6)
    assert ps.metadata["topology"]["process_count"] == 1
    assert ps.metadata["topology"]["global_shapes"]["conv_W"] == \
        [3, 3, 2, 4]
    # the fit's base seed, as the JAX package records it: the first fit's
    assert ps.rng_seed == js.rng_seed == 0


def test_capture_is_a_copy_and_restore_keeps_the_windows(tmp_path):
    sd = _mlp("port")
    x, y = _data(4, seed=1)
    it = DeviceCachedIterator(x, y, batch_size=B, device="cpu")
    sd.fit(it, epochs=1, listeners=[_quiet(Listener)])
    ptrs = {k: v.data_ptr() for k, v in sd.trainable_params().items()}
    wins = dict(sd._windows)
    assert wins
    snap = pck.capture_training_state(sd)
    before = {k: v.copy() for k, v in snap.arrays.items()}
    sd.fit(it, epochs=1, listeners=[_quiet(Listener)])
    assert sd.last_fit_stats["window_captures"] == 0
    _close(snap.arrays, before, rtol=0, atol=0)      # not a view
    pck.restore_training_state(sd, snap)
    assert {k: v.data_ptr() for k, v in sd.trainable_params().items()} \
        == ptrs
    assert sd._windows == wins
    assert sd.training_config.iteration_count == 4
    _close(_arrays("port", sd), before, rtol=0, atol=0)


def test_listener_checkpoints_resume_bit_exact(tmp_path):
    """Windows of 2, checkpoints every 4 iterations: the step-4 snapshot
    restored into a new network, trained over the last 4 batches, ends
    bit-equal to the uninterrupted 8 steps."""
    x, y = _data(8, seed=5)
    sd = _mlp("port")
    mgr = pck.CheckpointManager(tmp_path, keep_last_n=5)
    sd.fit(DeviceCachedIterator(x, y, batch_size=B, device="cpu"),
           listeners=[pck.CheckpointListener(mgr, every_n_iterations=4)])
    assert mgr.all_steps() == [4, 8]
    assert [r["step"] for r in mgr.records] == [4, 8]
    assert all(r["bytes"] > 0 for r in mgr.records)
    again = _mlp("port")
    mgr.restore(4, model=again)
    again.fit(DeviceCachedIterator(x[4 * B:], y[4 * B:], batch_size=B,
                                   device="cpu"))
    for k, v in sd.trainable_params().items():
        assert torch.equal(v, again.trainable_params()[k]), k
    for a, b in zip(sd._updater_state.values(),
                    again._updater_state.values()):
        assert all(torch.equal(p, q) for p, q in zip(a, b))
    mgr.close()


def _torn_dirs(root):
    """One intact step, then four kinds of damage both managers must skip
    and collect: no COMMIT marker, a truncated and a bit-flipped payload,
    a staging directory left by a killed writer."""
    sd = _mlp("port")
    mgr = pck.CheckpointManager(root, keep_last_n=None, async_write=False)
    for step in (2, 4, 6, 8, 10):
        sd.training_config.iteration_count = step
        mgr.save(step, model=sd)
    d = lambda s: os.path.join(root, f"step_{s:08d}")
    os.remove(os.path.join(d(4), "COMMIT"))                   # no marker
    with open(os.path.join(d(6), "arrays.npz"), "r+b") as fh:  # truncated
        fh.truncate(20)
    with open(os.path.join(d(8), "arrays.npz"), "r+b") as fh:  # bit flip
        fh.seek(60)
        b = fh.read(1)
        fh.seek(60)
        fh.write(bytes([b[0] ^ 0xFF]))
    os.remove(os.path.join(d(10), "COMMIT"))            # killed writer
    os.replace(d(10), d(10) + ".tmp")
    return sd


def test_torn_and_uncommitted_dirs_are_refused_and_collected(tmp_path):
    _torn_dirs(str(tmp_path))
    jmgr, pmgr = jck.CheckpointManager(tmp_path), \
        pck.CheckpointManager(tmp_path)
    assert sorted(pmgr.uncommitted_dirs()) == sorted(
        jmgr.uncommitted_dirs())
    assert len(pmgr.uncommitted_dirs()) == 4     # 4, 6, 8 and 10.tmp
    assert pmgr.all_steps() == jmgr.all_steps()
    step, _ = pmgr.restore_latest(model=_mlp("port"))
    assert step == 2 == jmgr.restore_latest()[0]
    with pytest.raises(pck.CheckpointError, match="not committed"):
        pmgr.restore(8)
    removed = pmgr.gc_uncommitted()
    assert len(removed) == 4
    assert sorted(os.listdir(tmp_path)) == ["step_00000002"]
    assert pmgr.latest_verified_step() is None
    assert pmgr.restore_latest(verified_only=True)[0] == 2


def test_a_resave_staged_aside_is_recovered(tmp_path):
    """A crash between a re-save's two renames leaves ``step_N.old``:
    the next manager renames it back, as the JAX one does."""
    sd = _mlp("port")
    mgr = pck.CheckpointManager(tmp_path, async_write=False)
    mgr.save(3, model=sd)
    final = os.path.join(tmp_path, "step_00000003")
    os.replace(final, final + ".old")
    assert pck.CheckpointManager(tmp_path).all_steps() == [3]


def test_writer_errors_are_sticky(tmp_path, monkeypatch):
    from deeplearning4j_tpu_torch.checkpoint import manager
    sd = _mlp("port")
    mgr = pck.CheckpointManager(tmp_path)

    def broken(directory, state):
        raise OSError("disk full")

    monkeypatch.setattr(manager, "write_state_files", broken)
    mgr.save(1, model=sd)
    with pytest.raises(pck.CheckpointError, match="disk full"):
        mgr.wait_until_finished()
    monkeypatch.undo()
    mgr.save(2, model=sd)
    mgr.wait_until_finished()
    assert mgr.all_steps() == [2]
    assert any(os.path.basename(p) == "step_00000001.tmp"
               for p in mgr.gc_uncommitted())
    mgr.close()


def test_retention_matches_jax(tmp_path):
    sd = _mlp("port")
    out = {}
    for pkg, mod in (("jax", jck), ("port", pck)):
        root = tmp_path / pkg
        mgr = mod.CheckpointManager(root, keep_last_n=2,
                                    keep_every_n_epochs=3,
                                    pin_best_metric="loss",
                                    async_write=False)
        state = pck.capture_training_state(sd)
        for step in range(1, 9):
            state.epoch = step
            mgr.save(step, state=jck.TrainingState(**{
                f: getattr(state, f) for f in (
                    "arrays", "updater_leaves", "iteration", "epoch",
                    "rng_seed", "normalizer_state")},
                metadata={}) if pkg == "jax" else state,
                metrics={"loss": abs(step - 4.5)})
            if step == 2:
                mgr.pin(2)
        out[pkg] = (mgr.all_steps(), mgr.best_step())
    assert out["port"] == out["jax"]
    assert out["port"][0] == [2, 3, 4, 6, 7, 8]


def test_what_is_not_ported_is_refused_by_name(tmp_path):
    sd = _mlp("port")
    with pytest.raises(NotImplementedError, match="queue 1 item 7: ui/"):
        pck.CheckpointManager(tmp_path, stats_storage=object())
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        pck.capture_training_state(sd, normalizer=object())
    mgr = pck.CheckpointManager(tmp_path, async_write=False)
    mgr.save(1, model=sd)
    meta = json.loads((tmp_path / "step_00000001" / "state.json")
                      .read_text())
    assert meta["format_version"] == jck.state.FORMAT_VERSION == \
        pck.state.FORMAT_VERSION
    meta["shard_count"] = 2
    p = tmp_path / "step_00000001" / "state.json"
    p.write_text(json.dumps(meta))
    from deeplearning4j_tpu_torch.checkpoint import manifest
    manifest.write_manifest(str(tmp_path / "step_00000001"))
    with pytest.raises(pck.ShardCountMismatchError,
                       match="queue 1 item 7: checkpoint/reshard.py"):
        mgr.restore_latest()
    with pytest.raises(ValueError, match="does not cover"):
        pck.restore_training_state(_mlp("port"), pck.TrainingState(
            arrays={"w0": np.zeros((FEATS, 16), np.float32)}))


def test_async_writer_under_thread_pressure(tmp_path):
    """60 asynchronous saves of a small state, the writer thread and the
    training thread switching as often as the interpreter allows, the
    main thread listing and restoring between saves: every save commits
    exactly once, in order, retention keeps the newest two, and no
    staging directory is left."""
    import sys
    sd = _mlp("port")
    mgr = pck.CheckpointManager(tmp_path, keep_last_n=2)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for step in range(60):
            sd.training_config.iteration_count = step
            mgr.save(step, model=sd)
            steps = mgr.all_steps()
            assert steps == sorted(steps) and len(steps) <= 3
        mgr.wait_until_finished(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert [r["step"] for r in mgr.records] == list(range(60))
    assert mgr.all_steps() == [58, 59]
    assert mgr.uncommitted_dirs() == []
    assert mgr.restore_latest(model=_mlp("port"))[0] == 59
    mgr.close()
    assert not mgr._worker.is_alive()
