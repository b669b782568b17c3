"""MultiLayerNetwork: a sequential network compiled to the port's SameDiff.

Counterpart of ``deeplearning4j_tpu/nn/multilayer.py`` (``_WANTED_KIND``
:32, ``_adapt_itype`` :63, ``_type_walk``, ``_to_internal_layout`` :123,
``_build_graph`` :141, ``MultiLayerNetwork`` :181 with ``fit`` :217,
``fit_tbptt`` :243-413, ``output`` :430, ``evaluate`` :446-468, ``params``
:470, ``save``/``load`` :512-528; ``_ArrayIterator`` :528). As there, the configuration is recorded
into two SameDiff graphs from one seed, with the same parameter names and
initial values: a training graph and an inference graph, which hold the
same parameter and state tensors. They differ where the JAX package's
do: a batch norm normalizes with the batch statistics and updates the
running ones in the training graph, with the running ones in the
inference graph; dropout is in the training graph only. A convolutional
network output goes back to NCHW (``output_nchw``), as the JAX one's. ``fit`` is ``SameDiff.fit`` on the training graph (one execution
path), so it takes SameDiff's tiers: the scanned epoch, fused windows
(``fused_steps``) or one step a batch.

Users feed NCHW; a convolutional input is permuted to NHWC once
(``input_nhwc``), the convolutions and pools run on NHWC with HWIO
weights, and the flatten before a dense layer (``layer{i}_cnn2ff``) is
the NHWC flatten, so the dense weights are the JAX network's.

``serving_spec`` (JAX :422) hands ``ParallelInference`` an inference
graph of its own: the JAX sync moves references to immutable arrays, but
the port's updaters write the parameters in place, so a served graph
that shared the training graph's tensors would see a ``fit`` step by
step. The serving graph holds copies, which its sync refreshes.

The configuration's regularization and clipping reach the training
graph's ``TrainingConfig``; ``fit(accum_steps=..., sentinel=...)`` set
its gradient accumulation and divergence sentinel;
``capture_training_state``/``restore_training_state`` are
``checkpoint/state.py`` on the training graph (a restore copies into its
tensors, which the inference graph shares).

Sequences are (batch, time, features). ``fit`` on them is full BPTT on
the fit tiers. ``fit_tbptt`` builds, once a batch size, a TBPTT graph
whose recurrent layers keep their states in state variables, shares the
training graph's parameter tensors with it (so the trained weights are
the inference graph's too) and runs the TBPTT tier
(``autodiff/window.py`` ``fit_tbptt``); as in the JAX package that graph
keeps its own updater state and iteration. ``evaluate`` streams
``output`` into an ``Evaluation`` (or the given evaluation);
``save``/``load`` are the JAX ModelSerializer zip (``nn/model_serde.py``).
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig, window
from deeplearning4j_tpu_torch.environment import DeviceLike, default_device
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import (BaseLayer, InputType,
                                                SDBuildContext)

#: the input kinds each layer class takes, the first the one a
#: preprocessor converts to (a DenseLayer on rnn input runs per timestep);
#: a class not named takes any (JAX ``_WANTED_KIND`` :32)
_WANTED_KIND = {
    "DenseLayer": ("ff", "rnn"), "OutputLayer": ("ff",),
    "ConvolutionLayer": ("cnn",), "SubsamplingLayer": ("cnn",),
    "LSTMLayer": ("rnn",), "RnnOutputLayer": ("rnn",),
    "SimpleRnnLayer": ("rnn",), "Bidirectional": ("rnn",),
    "GravesLSTMLayer": ("rnn",), "GRULayer": ("rnn",),
    "LastTimeStepLayer": ("rnn",), "Deconvolution2DLayer": ("cnn",),
    "DepthwiseConvolution2DLayer": ("cnn",),
    "SeparableConvolution2DLayer": ("cnn",),
    "LocalResponseNormalization": ("cnn",), "Upsampling2DLayer": ("cnn",),
    "ZeroPaddingLayer": ("cnn",), "Cropping2DLayer": ("cnn",),
    "Yolo2OutputLayer": ("cnn",), "SpaceToDepthLayer": ("cnn",),
    "DepthToSpaceLayer": ("cnn",), "CnnLossLayer": ("cnn",),
    "CenterLossOutputLayer": ("ff",)}


def _not_ported(what: str, item: str, owner: str = "MultiLayerNetwork"):
    raise NotImplementedError(f"{owner}.{what} is not ported yet (ROADMAP "
                              f"queue 1 item {item})")


def _adapt_itype(itype: InputType, layer: BaseLayer, idx: int) -> InputType:
    """How an input type adapts to a layer's wanted kind: a cnn input
    flattens before a layer that wants ff (the reference's
    CnnToFeedForwardPreProcessor); a sequence before one is refused, as
    in the JAX package."""
    accepted = _WANTED_KIND.get(type(layer).__name__)
    if accepted is None or itype.kind in accepted:
        return itype
    if itype.kind == "cnn" and accepted[0] == "ff":
        return InputType.feed_forward(itype.flat_size)
    if itype.kind == "rnn" and accepted[0] == "ff":
        raise ValueError(
            f"layer {idx} ({type(layer).__name__}) wants flat input but got "
            f"a sequence; use LSTMLayer(return_sequences=False) or "
            f"GlobalPoolingLayer before it")
    raise ValueError(f"no preprocessor from {itype.kind} to {accepted[0]} "
                     f"(layer {idx}, {type(layer).__name__})")


def _type_walk(conf: MultiLayerConfiguration):
    """Yield (idx, layer, adapted input type, output type)."""
    itype = conf.input_type
    for idx, layer in enumerate(conf.layers):
        itype = _adapt_itype(itype, layer, idx)
        otype = layer.output_type(itype)
        yield idx, layer, itype, otype
        itype = otype


def _to_internal_layout(sd, x, itype: InputType, fmt: str, name: str):
    """NCHW as users feed it, permuted once to NHWC for the body."""
    if fmt != "NHWC" or itype.kind != "cnn":
        return x
    return sd.invoke("permute", [x], {"axes": (0, 2, 3, 1)}, name=name)


def _build_graph(conf: MultiLayerConfiguration, device: torch.device,
                 tbptt_batch: Optional[int] = None, training: bool = True):
    """``(graph, build context)`` of ``conf``: the training graph, or with
    ``training=False`` the inference one; with ``tbptt_batch``, the TBPTT
    graph, whose recurrent states are state variables (the context's
    ``rnn_state_vars``)."""
    sd = SameDiff(device=device)
    fmt = conf.cnn_data_format
    ctx = SDBuildContext(sd=sd, rng=np.random.default_rng(conf.seed),
                         dtype=conf.dtype, cnn_format=fmt,
                         tbptt_batch=tbptt_batch, training=training)
    x = sd.placeholder("input", shape=conf.input_type.placeholder_shape(),
                       dtype=conf.dtype)
    final = conf.input_type
    for _, _, _, final in _type_walk(conf):
        pass
    # a head whose labels differ from its output (YOLOv2's (B, 4+C, H, W))
    # declares their shape
    hook = getattr(conf.layers[-1] if conf.layers else None,
                   "labels_placeholder_shape", None)
    ctx.labels_var = sd.placeholder(
        "labels", shape=hook(final) if hook is not None
        else final.placeholder_shape(), dtype=conf.dtype)
    cur = _to_internal_layout(sd, x, conf.input_type, fmt, "input_nhwc")
    itype = conf.input_type
    for idx, layer in enumerate(conf.layers):
        new = _adapt_itype(itype, layer, idx)
        if new is not itype:
            cur = sd.invoke("reshape", [cur], {"shape": (-1, new.flat_size)},
                            name=f"layer{idx}_cnn2ff")
        ctx.idx = idx
        cur, itype = layer.build_sd(ctx, cur, new)
    if ctx.output_var is None:
        ctx.output_var = cur
    if itype.kind == "cnn" and fmt == "NHWC":
        ctx.output_var = sd.invoke("permute", [ctx.output_var],
                                   {"axes": (0, 3, 1, 2)},
                                   name="output_nchw")
    ctx.output_var.rename("output")
    return sd, ctx


class MultiLayerNetwork:
    def __init__(self, conf: MultiLayerConfiguration):
        self.conf = conf
        self._sd_train: Optional[SameDiff] = None
        self._sd_infer: Optional[SameDiff] = None
        self._score = float("nan")
        #: batch size -> (TBPTT graph, its recurrent state variables)
        self._tbptt_graphs: Dict[int, Tuple[SameDiff, List[str]]] = {}

    def init(self, device: DeviceLike = None) -> "MultiLayerNetwork":
        """Build both graphs on ``device`` (the CUDA card unless
        ``device="cpu"``)."""
        dev = default_device(device)
        self._sd_train, _ = _build_graph(self.conf, dev)
        self._sd_infer, _ = _build_graph(self.conf, dev, training=False)
        self._sync_infer()
        self._sd_train.training_config = self._training_config()
        self._tbptt_graphs = {}
        return self

    def _training_config(self) -> TrainingConfig:
        c = self.conf
        return TrainingConfig(
            updater=c.updater, data_set_feature_mapping=["input"],
            data_set_label_mapping=["labels"],
            regularization=c.regularization,
            grad_clip_value=c.grad_clip_value,
            mixed_precision=c.mixed_precision,
            gradient_normalization=c.gradient_normalization,
            gradient_normalization_threshold=(
                c.gradient_normalization_threshold))

    def _require_init(self):
        if self._sd_train is None:
            raise RuntimeError("call init() first")

    @property
    def samediff(self) -> SameDiff:
        """The training graph (the one execution path)."""
        self._require_init()
        return self._sd_train

    @property
    def device(self) -> torch.device:
        self._require_init()
        return self._sd_train.device

    def fit(self, data, labels=None, epochs: int = 1, batch_size: int = 32,
            listeners: Sequence = (), fused_steps: Optional[int] = None,
            accum_steps: Optional[int] = None,
            sentinel: Optional[bool] = None):
        """Train on an iterator of (features, labels) batches (e.g. a
        ``DeviceCachedIterator``), or on a feature array with
        ``labels=``. ``fused_steps``, ``accum_steps`` and ``sentinel`` set
        the config's K steps a dispatch, gradient accumulation and
        divergence sentinel for this and later fits."""
        self._require_init()
        tc = self._sd_train.training_config
        if fused_steps is not None:
            tc.fused_steps = int(fused_steps)
        if accum_steps is not None:
            if int(accum_steps) < 1:
                raise ValueError(f"accum_steps must be >= 1, got "
                                 f"{accum_steps}")
            tc.accum_steps = int(accum_steps)
        if sentinel is not None:
            tc.sentinel = bool(sentinel)
        if labels is not None:
            data = _ArrayIterator(_host_or_tensor(data),
                                  _host_or_tensor(labels), batch_size)
        history = self._sd_train.fit(data, epochs=epochs,
                                     listeners=listeners)
        self._score = history.final_loss()
        return history

    def fit_tbptt(self, features, labels, tbptt_length: int,
                  epochs: int = 1, batch_size: int = 32):
        """Truncated backprop through time (JAX ``fit_tbptt``; reference
        MultiLayerNetwork.doTruncatedBPTT): ``features`` (B, T, C) and
        ``labels`` (B, T, C_out), numpy arrays or tensors, cut into chunks
        of ``tbptt_length`` timesteps. The recurrent states start at zero
        for every minibatch of ``batch_size`` sequences and are carried
        from chunk to chunk, detached (the truncation); ``tbptt_length >=
        T`` is full BPTT. A minibatch's full chunks are one fit window
        (one CUDA graph replay on the card), a ragged tail one eager step;
        the iteration advances a chunk. Sequences that do not fill a last
        batch are dropped, with a warning. Returns a ``History`` (epoch
        means, each chunk's loss; one fetch for the fit)."""
        self._require_init()
        if features.ndim != 3 or labels.ndim != 3:
            raise ValueError("fit_tbptt needs sequence features (B, T, C) "
                             "and per-timestep labels (B, T, C_out)")
        t_len = features.shape[1]
        if labels.shape[1] != t_len:
            raise ValueError(f"labels T={labels.shape[1]} != features "
                             f"T={t_len}")
        n = (len(features) // batch_size) * batch_size
        if n == 0:
            raise ValueError("dataset smaller than one batch")
        if n < len(features):
            warnings.warn(
                f"fit_tbptt: dropping {len(features) - n} of "
                f"{len(features)} sequences that do not fill a full batch "
                f"of {batch_size} (TBPTT state vars have a fixed batch "
                f"dimension)")
        sd, states = self._tbptt_graph(batch_size)
        sd.training_config.sentinel = bool(
            self._sd_train.training_config.sentinel)
        history = window.fit_tbptt(sd, features, labels, tbptt_length,
                                   batch_size, epochs, states)
        with torch.no_grad():      # non-recurrent state (e.g. statistics)
            for sn, arr in sd.state_vars_map().items():
                if sn not in states and sn in self._sd_train._arrays:
                    self._sd_train._arrays[sn].copy_(arr)
        self._score = history.final_loss()
        return history

    def _tbptt_graph(self, batch_size: int):
        """The TBPTT graph for ``batch_size`` (built once), holding the
        training graph's current parameter tensors."""
        if batch_size not in self._tbptt_graphs:
            sd, ctx = _build_graph(self.conf, self.device, batch_size)
            sd.training_config = self._training_config()
            self._tbptt_graphs[batch_size] = (sd, list(ctx.rnn_state_vars))
        sd, states = self._tbptt_graphs[batch_size]
        moved = False
        for n, arr in self._sd_train._arrays.items():
            cur = sd._arrays.get(n)
            if cur is not None and cur is not arr and cur.shape == arr.shape:
                sd._arrays[n] = arr
                moved = True
        if moved:
            sd._changed()
        return sd, states

    def evaluate(self, data, labels=None, evaluation=None,
                 batch_size: int = 256):
        """Stream ``output`` over an iterator of (features, labels) or
        arrays into ``evaluation`` (default a new ``Evaluation``) and
        return it (JAX ``evaluate``; reference
        MultiLayerNetwork.evaluate(DataSetIterator)). ``Evaluation`` takes
        (N, C) outputs only, as the JAX one: a sequence model's (B, T, C)
        output raises there."""
        from deeplearning4j_tpu_torch.evaluation import Evaluation
        ev = evaluation or Evaluation()
        if labels is not None:
            data = _ArrayIterator(_host_or_tensor(data),
                                  _host_or_tensor(labels), batch_size)
        if hasattr(data, "reset"):
            data.reset()
        for batch in data:
            if isinstance(batch, dict):
                feats, labs = batch["input"], batch["labels"]
            elif hasattr(batch, "features"):
                feats, labs = batch.features, batch.labels
            else:
                feats, labs = batch
            ev.eval(labs, self.output(feats))
        return ev

    def save(self, path, include_updater_state: bool = True) -> None:
        """The ModelSerializer zip (``nn/model_serde.py``) of the training
        graph: configuration JSON, parameters, updater state, iteration."""
        from deeplearning4j_tpu_torch.nn.model_serde import save_net_zip
        self._require_init()
        save_net_zip(path, self.conf.to_json(), self._sd_train,
                     include_updater_state)

    @staticmethod
    def load(path, device: DeviceLike = None) -> "MultiLayerNetwork":
        """A network from a zip either package wrote, on ``device`` (the
        CUDA card unless ``device="cpu"``)."""
        from deeplearning4j_tpu_torch.nn.model_serde import (
            read_net_zip, restore_net_state)
        conf_json, arrays, leaves, iteration = read_net_zip(path)
        net = MultiLayerNetwork(
            MultiLayerConfiguration.from_json(conf_json)).init(device)
        return restore_net_state(net, arrays, leaves, iteration)

    def _sync_infer(self):
        """The inference graph holds the training graph's tensors."""
        tgt = self._sd_infer
        for n, arr in self._sd_train._arrays.items():
            if n in tgt._arrays:
                tgt._arrays[n] = arr

    def serving_spec(self):
        """The serving contract (JAX ``MultiLayerNetwork.serving_spec``):
        ``(graph, ["input"], ["output"], sync)``. ``graph`` is an inference
        SameDiff built from the configuration, holding its own copies of
        the parameters (one more parameter set on the device); ``sync``
        copies the training graph's current values into it, so served
        outputs change only when the server calls it
        (``ParallelInference.update_model``)."""
        self._require_init()
        serve, _ = _build_graph(self.conf, self.device, training=False)

        def sync():
            with torch.no_grad():
                for n, arr in self._sd_train._arrays.items():
                    if n in serve._arrays:
                        serve._arrays[n].copy_(arr)
        return serve, ["input"], ["output"], sync

    def output(self, x, training: bool = False) -> torch.Tensor:
        """Forward pass (reference: MultiLayerNetwork.output :2471)."""
        self._require_init()
        if training:
            return self._sd_train.output({"input": x}, ["output"])["output"]
        self._sync_infer()
        return self._sd_infer.output({"input": x}, ["output"])["output"]

    def predict(self, x) -> np.ndarray:
        """Class indices (reference: MultiLayerNetwork.predict)."""
        return self.output(x).argmax(dim=-1).cpu().numpy()

    def score(self) -> float:
        """The last fit's final epoch loss."""
        return self._score

    def params(self) -> Dict[str, np.ndarray]:
        """Copies of the parameters and state variables under the JAX
        names and layouts."""
        self._require_init()
        sd = self._sd_train
        return {n: np.array(a.detach().cpu().numpy(), copy=True)
                for n, a in {**sd.trainable_params(),
                             **sd.state_vars_map()}.items()}

    def set_param(self, name: str, value) -> None:
        self._require_init()
        self._sd_train.set_arr_for_var(name, value)

    def num_params(self) -> int:
        self._require_init()
        return sum(a.numel()
                   for a in self._sd_train.trainable_params().values())

    def summary(self) -> str:
        lines = [f"MultiLayerNetwork: {len(self.conf.layers)} layers, "
                 f"{self.num_params() if self._sd_train else '?'} params"]
        for i, layer, itype, otype in _type_walk(self.conf):
            lines.append(f"  {i}: {type(layer).__name__:<22} "
                         f"{itype.dims} -> {otype.dims}")
        return "\n".join(lines)

    # -- checkpointing (checkpoint/) --------------------------------------
    def capture_training_state(self, epoch: int = 0, normalizer=None):
        """A host snapshot for the checkpoint manager
        (``checkpoint.capture_training_state``)."""
        from deeplearning4j_tpu_torch.checkpoint import capture_training_state
        return capture_training_state(self, epoch=epoch,
                                      normalizer=normalizer)

    def restore_training_state(self, state, strict: bool = True):
        """Copy a ``TrainingState`` into this initialized network."""
        from deeplearning4j_tpu_torch.checkpoint import restore_training_state
        return restore_training_state(self, state, strict=strict)


def _host_or_tensor(a):
    """A tensor as it is (on its device); anything else as a numpy
    array."""
    return a if isinstance(a, torch.Tensor) else np.asarray(a)


class _ArrayIterator:
    """In-memory batches over feature/label arrays (``fit(X, Y)`` of
    ``MultiLayerNetwork`` and ``ComputationGraph``)."""

    def __init__(self, X, Y, batch: int):
        self.Xs = list(X) if isinstance(X, (list, tuple)) else [X]
        self.Ys = list(Y) if isinstance(Y, (list, tuple)) else [Y]
        self.batch = batch

    def reset(self):
        pass

    def __iter__(self):
        n = len(self.Xs[0])
        for i in range(0, n, self.batch):
            feats = [X[i:i + self.batch] for X in self.Xs]
            labs = [Y[i:i + self.batch] for Y in self.Ys]
            yield (feats if len(feats) > 1 else feats[0],
                   labs if len(labs) > 1 else labs[0])
