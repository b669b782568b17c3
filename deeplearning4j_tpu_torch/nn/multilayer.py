"""MultiLayerNetwork: a sequential network compiled to the port's SameDiff.

Counterpart of ``deeplearning4j_tpu/nn/multilayer.py`` (``_adapt_itype``
:63, ``_type_walk``, ``_to_internal_layout`` :123, ``_build_graph`` :141,
``MultiLayerNetwork`` :181 with ``fit`` :217, ``output`` :430, ``params``
:470; ``_ArrayIterator`` :528). As there, the configuration is recorded
into two SameDiff graphs from one seed, with the same parameter names and
initial values: a training graph and an inference graph, which hold the
same parameter tensors (no layer of this slice differs between the
two). ``fit`` is ``SameDiff.fit`` on the training graph (one execution
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

Not ported yet, each refused by name: ``fit_tbptt``, ``save``/``load``
and ``evaluate``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
from deeplearning4j_tpu_torch.environment import DeviceLike, default_device
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import (BaseLayer, ConvolutionLayer,
                                                DenseLayer, InputType,
                                                OutputLayer, SDBuildContext,
                                                SubsamplingLayer)

_WANTED_KIND = {DenseLayer: ("ff",), OutputLayer: ("ff",),
                ConvolutionLayer: ("cnn",), SubsamplingLayer: ("cnn",)}


def _not_ported(what: str, item: str, owner: str = "MultiLayerNetwork"):
    raise NotImplementedError(f"{owner}.{what} is not ported yet (ROADMAP "
                              f"queue 1 item {item})")


def _adapt_itype(itype: InputType, layer: BaseLayer, idx: int) -> InputType:
    """How an input type adapts to a layer's wanted kind: a cnn input
    flattens before a layer that wants ff (the reference's
    CnnToFeedForwardPreProcessor); the only rule this slice needs."""
    accepted = _WANTED_KIND.get(type(layer))
    if accepted is None or itype.kind in accepted:
        return itype
    if itype.kind == "cnn" and accepted[0] == "ff":
        return InputType.feed_forward(itype.flat_size)
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


def _build_graph(conf: MultiLayerConfiguration, device: torch.device):
    sd = SameDiff(device=device)
    fmt = conf.cnn_data_format
    ctx = SDBuildContext(sd=sd, rng=np.random.default_rng(conf.seed),
                         dtype=conf.dtype, cnn_format=fmt)
    x = sd.placeholder("input", shape=conf.input_type.placeholder_shape(),
                       dtype=conf.dtype)
    final = conf.input_type
    for _, _, _, final in _type_walk(conf):
        pass
    ctx.labels_var = sd.placeholder("labels",
                                    shape=final.placeholder_shape(),
                                    dtype=conf.dtype)
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
    if itype.kind == "cnn":
        raise NotImplementedError(
            "a MultiLayerNetwork whose output is convolutional is not "
            "ported yet (ROADMAP queue 1 item 10: nn/ layers)")
    ctx.output_var.rename("output")
    return sd


class MultiLayerNetwork:
    def __init__(self, conf: MultiLayerConfiguration):
        self.conf = conf
        self._sd_train: Optional[SameDiff] = None
        self._sd_infer: Optional[SameDiff] = None
        self._score = float("nan")

    def init(self, device: DeviceLike = None) -> "MultiLayerNetwork":
        """Build both graphs on ``device`` (the CUDA card unless
        ``device="cpu"``)."""
        dev = default_device(device)
        self._sd_train = _build_graph(self.conf, dev)
        self._sd_infer = _build_graph(self.conf, dev)
        self._sync_infer()
        c = self.conf
        self._sd_train.training_config = TrainingConfig(
            updater=c.updater, data_set_feature_mapping=["input"],
            data_set_label_mapping=["labels"],
            regularization=c.regularization,
            grad_clip_value=c.grad_clip_value,
            mixed_precision=c.mixed_precision,
            gradient_normalization=c.gradient_normalization,
            gradient_normalization_threshold=(
                c.gradient_normalization_threshold))
        return self

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
            data = _ArrayIterator(np.asarray(data), np.asarray(labels),
                                  batch_size)
        history = self._sd_train.fit(data, epochs=epochs,
                                     listeners=listeners)
        self._score = history.final_loss()
        return history

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
        serve = _build_graph(self.conf, self.device)

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
        """Copies of the parameters under the JAX names and layouts."""
        self._require_init()
        return {n: np.array(a.detach().cpu().numpy(), copy=True)
                for n, a in self._sd_train.trainable_params().items()}

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

    # -- not ported yet ---------------------------------------------------
    def fit_tbptt(self, *a, **k):
        _not_ported("fit_tbptt", "10: recurrent layers")

    def evaluate(self, *a, **k):
        _not_ported("evaluate", "10: evaluation/")

    def save(self, *a, **k):
        _not_ported("save", "10: model_serde")

    @staticmethod
    def load(*a, **k):
        _not_ported("load", "10: model_serde")

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
