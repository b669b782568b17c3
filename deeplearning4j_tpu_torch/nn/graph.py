"""ComputationGraph: DAG networks built as one ``nn.Module``.

Counterpart of ``deeplearning4j_tpu/nn/graph.py`` (``ElementWiseVertex``
:88, ``ComputationGraphConfiguration`` :263, ``GraphBuilder`` :314,
``_build_graph`` :392, ``ComputationGraph`` :462). Where the JAX package
records the DAG into a SameDiff graph and lets ``jax.grad`` derive the
backward, the port builds a :class:`GraphModule` that runs the nodes in
order and takes PyTorch's autograd.

The external contract is NCHW, as in the JAX package; the network body
runs ``torch.channels_last``, so that a batch-norm input is an (R, C)
view of memory. A ``BatchNormalization`` node whose only consumer is a
ReLU ``ActivationLayer`` becomes one fused BN+ReLU module (the
activation node passes its input through), so that its backward is the
BN+ReLU kernel pair with the mask.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from deeplearning4j_tpu_torch.autodiff.training import (History,
                                                        MixedPrecision,
                                                        TrainingConfig,
                                                        torch_dtype)
from deeplearning4j_tpu_torch.convert import params_to_jax
from deeplearning4j_tpu_torch.environment import DeviceLike, default_device
from deeplearning4j_tpu_torch.learning.updaters import IUpdater, Sgd, stage_
from deeplearning4j_tpu_torch.nn.activations import (activation_fn,
                                                     resolve_activation)
from deeplearning4j_tpu_torch.nn.layers import (
    ActivationLayer, BaseLayer, BatchNorm, BatchNormalization, BuildContext,
    Head, InputType)


# ----------------------------------------------------------------------
class GraphVertex:
    def output_type(self, itypes: List[InputType]) -> InputType:
        raise NotImplementedError

    def build(self, ctx: BuildContext, itypes: List[InputType]) -> nn.Module:
        raise NotImplementedError


class Add(nn.Module):
    def forward(self, *xs):
        acc = xs[0]
        for x in xs[1:]:
            acc = acc + x
        return acc


@dataclasses.dataclass
class ElementWiseVertex(GraphVertex):
    """Pointwise combine. This slice ports Add (ResNet's shortcuts)."""
    op: str = "Add"

    def output_type(self, itypes):
        return itypes[0]

    def build(self, ctx, itypes):
        if self.op.lower() != "add":
            raise NotImplementedError(
                f"element-wise op {self.op!r} is not ported yet (Add)")
        return Add()


# ----------------------------------------------------------------------
@dataclasses.dataclass
class _Node:
    name: str
    op: object                # BaseLayer or GraphVertex
    inputs: List[str]


@dataclasses.dataclass
class ComputationGraphConfiguration:
    inputs: List[str]
    input_types: List[InputType]
    nodes: List[_Node]
    outputs: List[str]
    seed: int = 12345
    updater: IUpdater = dataclasses.field(default_factory=lambda: Sgd(0.01))
    dtype: str = "float32"
    mixed_precision: Optional[MixedPrecision] = None


class GraphBuilder:
    def __init__(self, parent=None):
        self._parent = parent
        self._inputs: List[str] = []
        self._input_types: List[InputType] = []
        self._nodes: List[_Node] = []
        self._outputs: List[str] = []

    def add_inputs(self, *names: str) -> "GraphBuilder":
        self._inputs.extend(names)
        return self

    def set_input_types(self, *types: InputType) -> "GraphBuilder":
        self._input_types = list(types)
        return self

    def add_layer(self, name: str, layer: BaseLayer,
                  *inputs: str) -> "GraphBuilder":
        self._nodes.append(_Node(name, layer, list(inputs)))
        return self

    def add_vertex(self, name: str, vertex: GraphVertex,
                   *inputs: str) -> "GraphBuilder":
        self._nodes.append(_Node(name, vertex, list(inputs)))
        return self

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._outputs = list(names)
        return self

    def build(self) -> ComputationGraphConfiguration:
        if not self._inputs or not self._outputs:
            raise ValueError(
                "graph needs add_inputs(...) and set_outputs(...)")
        if len(self._input_types) != len(self._inputs):
            raise ValueError("set_input_types must match add_inputs")
        known = set(self._inputs)
        if len(known) != len(self._inputs):
            raise ValueError("duplicate input names")
        for n in self._nodes:
            if n.name in known:
                raise ValueError(f"duplicate node name {n.name!r} "
                                 f"(or it shadows an input)")
            if "." in n.name:
                raise ValueError(f"node name {n.name!r} contains '.'")
            if isinstance(n.op, BaseLayer) and len(n.inputs) != 1:
                raise ValueError(f"layer node {n.name!r} has "
                                 f"{len(n.inputs)} inputs; layers take one")
            for i in n.inputs:
                if i not in known:
                    raise ValueError(f"node {n.name!r} references unknown "
                                     f"input {i!r} (define nodes in "
                                     f"topological order)")
            known.add(n.name)
        for o in self._outputs:
            if o not in known:
                raise ValueError(f"unknown output {o!r}")
        kw = {}
        p = self._parent
        if p is not None:
            kw = {"seed": p._seed, "updater": p._updater, "dtype": p._dtype,
                  "mixed_precision": p._mixed_precision}
        return ComputationGraphConfiguration(
            inputs=self._inputs, input_types=self._input_types,
            nodes=self._nodes, outputs=self._outputs, **kw)


# ----------------------------------------------------------------------
def _fused_bn_relu(conf: ComputationGraphConfiguration) -> Dict[str, str]:
    """BN node -> its ReLU activation node, where that is its only
    consumer and the BN is not itself a graph output."""
    consumers: Dict[str, List[_Node]] = {}
    for node in conf.nodes:
        for i in node.inputs:
            consumers.setdefault(i, []).append(node)
    fused = {}
    for node in conf.nodes:
        users = consumers.get(node.name, [])
        if (isinstance(node.op, BatchNormalization) and len(users) == 1
                and node.name not in conf.outputs
                and isinstance(users[0].op, ActivationLayer)
                and resolve_activation(users[0].op.activation) == "relu"):
            fused[node.name] = users[0].name
    return fused


class GraphModule(nn.ModuleDict):
    """The DAG's nodes by name, run in order. Inputs are NCHW; the body
    runs channels-last; cnn outputs go back to contiguous NCHW. Returns
    one tensor per graph output (a loss head's pre-activation logits)."""

    def __init__(self, conf: ComputationGraphConfiguration,
                 modules: Dict[str, nn.Module],
                 types: Dict[str, InputType]):
        super().__init__(modules)
        self.conf = conf
        self.types = types

    def forward(self, *inputs):
        vals = {}
        for name, itype, x in zip(self.conf.inputs, self.conf.input_types,
                                  inputs):
            if itype.kind == "cnn":
                x = x.contiguous(memory_format=torch.channels_last)
            vals[name] = x
        for node in self.conf.nodes:
            vals[node.name] = self[node.name](*[vals[i] for i in node.inputs])
        return [vals[o].contiguous() if self.types[o].kind == "cnn"
                else vals[o] for o in self.conf.outputs]


def _build_graph(conf: ComputationGraphConfiguration,
                 device: torch.device) -> GraphModule:
    ctx = BuildContext(rng=np.random.default_rng(conf.seed), device=device,
                       dtype=torch_dtype(conf.dtype))
    types: Dict[str, InputType] = dict(zip(conf.inputs, conf.input_types))
    fused = _fused_bn_relu(conf)
    passthrough = set(fused.values())
    modules: Dict[str, nn.Module] = {}
    for node in conf.nodes:
        itypes = [types[i] for i in node.inputs]
        if isinstance(node.op, BaseLayer):
            mod = node.op.build(ctx, itypes[0])
            otype = node.op.output_type(itypes[0])
            if isinstance(mod, BatchNorm):
                mod.relu = node.name in fused
            if node.name in passthrough:
                mod = nn.Identity()
        else:
            mod = node.op.build(ctx, itypes)
            otype = node.op.output_type(itypes)
        modules[node.name] = mod
        types[node.name] = otype
    return GraphModule(conf, modules, types)


def _split_batch(batch):
    if hasattr(batch, "features"):
        feats, labels = batch.features, batch.labels
    else:
        feats, labels = batch
    feats = list(feats) if isinstance(feats, (list, tuple)) else [feats]
    labels = list(labels) if isinstance(labels, (list, tuple)) else [labels]
    return feats, labels


class ComputationGraph:
    def __init__(self, conf: ComputationGraphConfiguration):
        self.conf = conf
        self.model: Optional[GraphModule] = None
        self.device: Optional[torch.device] = None
        self.training_config: Optional[TrainingConfig] = None
        self._params: List[nn.Parameter] = []
        self._updater_state = None
        self._scal: Optional[torch.Tensor] = None   # the step's scalar
        self._score = float("nan")

    def init(self, device: DeviceLike = None) -> "ComputationGraph":
        """Build the network on ``device`` (the CUDA card unless
        ``device="cpu"``)."""
        mp = self.conf.mixed_precision
        if mp is not None and (mp.loss_scale is not None
                               or mp.softmax_dtype is not None):
            raise NotImplementedError(
                "ComputationGraph does not take MixedPrecision.loss_scale or "
                "softmax_dtype yet; SameDiff.fit does")
        self.device = default_device(device)
        self.model = _build_graph(self.conf, self.device)
        self._params = list(self.model.parameters())
        self.training_config = TrainingConfig(updater=self.conf.updater)
        self._updater_state = None
        return self

    def _require_init(self):
        if self.model is None:
            raise RuntimeError("call init() first")

    @property
    def compute_dtype(self) -> torch.dtype:
        mp = self.conf.mixed_precision
        return mp.dtype if mp is not None else torch_dtype(self.conf.dtype)

    def _on_device(self, a, dtype: torch.dtype) -> torch.Tensor:
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(
            np.asarray(a))
        return t.to(device=self.device, dtype=dtype)

    # ------------------------------------------------------------------
    def output(self, *inputs) -> List[torch.Tensor]:
        """Inference forward (running statistics); one tensor per graph
        output, with each loss head's activation applied."""
        self._require_init()
        self.model.eval()
        dtype = torch_dtype(self.conf.dtype)
        with torch.no_grad():
            outs = self.model(*[self._on_device(x, dtype) for x in inputs])
        return [activation_fn(self.model[o].activation)(z)
                if isinstance(self.model[o], Head) else z
                for o, z in zip(self.conf.outputs, outs)]

    def _train_step(self, feats, labels) -> torch.Tensor:
        cdt = self.compute_dtype
        self.model.train()
        xs = [self._on_device(x, cdt) for x in feats]
        ys = [self._on_device(y, cdt) for y in labels]
        heads = [(o, self.model[o]) for o in self.conf.outputs
                 if isinstance(self.model[o], Head)]
        if len(ys) != len(heads):
            raise ValueError(f"{len(ys)} label arrays for {len(heads)} "
                             f"loss heads")
        with torch.enable_grad():
            outs = dict(zip(self.conf.outputs, self.model(*xs)))
            loss = sum(head.loss(outs[o], y).float()
                       for (o, head), y in zip(heads, ys))
        grads = torch.autograd.grad(loss, self._params)
        tc = self.training_config
        if self._updater_state is None:
            self._updater_state = tc.updater.init(self._params)
            self._scal = torch.zeros(1, dtype=torch.float32,
                                     device=self._params[0].device)
        stage_(self._scal, tc.updater.step_scalars([tc.iteration_count]))
        tc.updater.update_(self._params, grads, self._updater_state,
                           self._scal[0])
        tc.iteration_count += 1
        return loss.detach()

    def fit(self, data, epochs: int = 1) -> History:
        """Train on an iterable of (features, labels) batches or of
        ``DataSet``s, ``epochs`` times over. One step per batch: forward,
        autograd backward, the updater in place on the masters."""
        self._require_init()
        history = History()
        for epoch in range(epochs):
            losses = [self._train_step(*_split_batch(b)) for b in data]
            if not losses:
                raise ValueError("fit got no batches")
            history.add_epoch(epoch, torch.stack(losses).mean().item())
        self._score = history.final_loss()
        return history

    def score(self) -> float:
        return self._score

    def params(self) -> Dict[str, np.ndarray]:
        """Parameters and batch-norm running statistics under the JAX
        package's names and layouts (conv weights HWIO)."""
        self._require_init()
        return params_to_jax(self.model.state_dict())

    def num_params(self) -> int:
        self._require_init()
        return sum(p.numel() for p in self._params)
