"""ComputationGraph: DAG networks built as one ``nn.Module``.

Counterpart of ``deeplearning4j_tpu/nn/graph.py`` (the vertices :33-260,
``ComputationGraphConfiguration`` :263, ``GraphBuilder`` :314,
``_build_graph`` :392, ``ComputationGraph`` :462 with ``fit`` :489,
``output`` :531, ``feed_forward`` :543 and ``summary`` :568). Where the
JAX package records the DAG into a SameDiff graph and lets ``jax.grad``
derive the backward, the port builds a :class:`GraphModule` that runs the
nodes in order and takes PyTorch's autograd.

The external contract is NCHW, as in the JAX package; the network body
runs ``torch.channels_last``, so that a batch-norm input is an (R, C)
view of memory. A ``BatchNormalization`` node whose only consumer is a
ReLU ``ActivationLayer`` becomes one fused BN+ReLU module (the
activation node passes its input through), so that its backward is the
BN+ReLU kernel pair with the mask.

A loss head is any module with ``is_loss_head`` (``Head`` of an
``OutputLayer``, ``LossHead``, and the YOLOv2, CNN-loss and center-loss
heads of ``nn/layers_ext.py``): ``output(z)`` is what ``output()``
returns for it and ``loss(z, labels, x)`` its loss, ``x`` its input. The
step sums every head's loss in float32 (JAX: each head marks its loss),
with the labels in the JAX package's order and layouts (a cnn head's
labels NCHW, YOLOv2's (B, 4+C, H, W)). Dropout draws on the card from the
fit's base seed, the step's iteration and the node's index in the
configuration (``ops/random.py``); ``output(training=True)`` and
``feed_forward(training=True)`` draw with the next seed, as the JAX
package's training-graph calls take one.

``fit`` takes the JAX signature and SameDiff's fit tiers
(``autodiff/window.py``): the graph owns its train step
(``window.StepOwner``), so the scanned epoch and fused windows are CUDA
graph replays on the card. The step casts once, where the batch is
bound, and runs under the mixed-precision policy of the JAX train step:
the float32 masters cast to the compute dtype in each module, the loss
heads under ``MixedPrecision.softmax_dtype``, the loss summed in float32
and multiplied by ``loss_scale`` before the backward, the gradients
divided by it.

``serving_spec`` (JAX :520) hands ``ParallelInference`` a
:class:`ServingGraph`: a ``GraphModule`` of its own in inference mode,
whose parameters and running statistics are copies that its ``sync``
refreshes. The JAX server sees new arrays only when its sync runs (its
train graph is functional); the port's updaters write the parameters in
place, so a server that shared them would see a ``fit`` step by step.

``fit(accum_steps=..., sentinel=...)`` and the configuration's
``regularization`` (the builder's ``l1``/``l2``/``weight_decay``) are the
JAX options, run by ``autodiff/step.py``. ``capture_training_state`` /
``restore_training_state`` (``checkpoint/state.py``) write and read the
JAX package's names and layouts (convolution weights HWIO), and a
restore copies into the live tensors, so the captured windows stay
valid.

Recurrent inputs are (B, T, C) sequences; a vertex's feature axis is then
2 (JAX: the same). A layer that wants ff input gets a cnn input flattened
first (NCHW order, the JAX graph's ``_adapt_input`` in its NCHW layout).
``ComputationGraphConfiguration.to_json``/``from_json`` and each vertex's
JSON (JAX :42-56, :276-300) write and read the JAX package's form.
``evaluate`` (JAX :580-594) streams ``output`` into an ``Evaluation`` or
the evaluation given; ``save``/``load`` (:610-624) are the JAX
ModelSerializer zip (``nn/model_serde.py``): either package loads the
other's.
"""
from __future__ import annotations

import dataclasses
import functools
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from deeplearning4j_tpu_torch.autodiff import window
from deeplearning4j_tpu_torch.autodiff.training import (History,
                                                        MixedPrecision,
                                                        TrainingConfig,
                                                        torch_dtype)
from deeplearning4j_tpu_torch.convert import params_to_jax
from deeplearning4j_tpu_torch.environment import DeviceLike, default_device
from deeplearning4j_tpu_torch.learning.regularization import Regularization
from deeplearning4j_tpu_torch.learning.updaters import IUpdater, Sgd
from deeplearning4j_tpu_torch.nn.activations import resolve_activation
from deeplearning4j_tpu_torch.nn.layers import (
    ActivationLayer, BaseLayer, BatchNorm, BatchNormalization, BuildContext,
    InputType, running_stats_frozen)
from deeplearning4j_tpu_torch.nn.multilayer import _ArrayIterator, _adapt_itype
from deeplearning4j_tpu_torch.ops import loss as loss_ops


# ----------------------------------------------------------------------
# graph vertices (JAX ``nn/graph.py`` :33-260). The body is logical NCHW
# (channels-last in memory), so a vertex's feature axis is 1 for ff and
# cnn inputs alike, and 2 for (B, T, C) sequences.
class GraphVertex:
    """``output_type(itypes)``; ``build(ctx, itypes) -> nn.Module`` that
    takes the inputs' tensors; ``to_json``/``from_json`` the JAX
    package's form (JAX :42-56)."""

    def output_type(self, itypes: List[InputType]) -> InputType:
        raise NotImplementedError

    def build(self, ctx: BuildContext, itypes: List[InputType]) -> nn.Module:
        raise NotImplementedError

    def to_json(self) -> dict:
        d = {"@class": type(self).__name__}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            d[f.name] = list(v) if isinstance(v, tuple) else v
        return d

    @staticmethod
    def from_json(d: dict) -> "GraphVertex":
        d = dict(d)
        name = d.pop("@class")
        cls = VERTEX_TYPES.get(name)
        if cls is None:
            raise NotImplementedError(
                f"vertex {name!r} is not ported yet (ROADMAP queue 1 item "
                f"1); the port's: {sorted(VERTEX_TYPES)}")
        kw = {f.name: tuple(d[f.name]) if isinstance(d.get(f.name), list)
              else d[f.name]
              for f in dataclasses.fields(cls) if f.name in d}
        return cls(**kw)


def _feature_axis(itypes: List[InputType]) -> int:
    return 2 if itypes[0].kind == "rnn" else 1


@functools.lru_cache(maxsize=None)
def _scalar_in(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``: the JAX package's vertex constants
    take the compute dtype (a weak-typed scalar, or the mixed-precision
    cast)."""
    return torch.tensor(value, dtype=dtype).item()


class VertexFn(nn.Module):
    """A vertex: ``fn`` of its input tensors; ``cnn`` outputs are kept
    channels-last in memory."""

    def __init__(self, fn, cnn: bool):
        super().__init__()
        self.fn, self.cnn = fn, cnn

    def forward(self, *xs):
        out = self.fn(*xs)
        return out.contiguous(memory_format=torch.channels_last) \
            if self.cnn else out


def _cnn(itypes: List[InputType]) -> bool:
    return itypes[0].kind == "cnn"


@dataclasses.dataclass
class MergeVertex(GraphVertex):
    """Concatenation along the feature axis (JAX ``MergeVertex`` :60)."""

    def output_type(self, itypes):
        n = sum(t.dims[0] for t in itypes)
        return InputType(itypes[0].kind, (n,) + itypes[0].dims[1:])

    def build(self, ctx, itypes):
        axis = _feature_axis(itypes)
        return VertexFn(lambda *xs: torch.cat(xs, dim=axis), _cnn(itypes))


def _average(*xs):
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    return acc * _scalar_in(1.0 / len(xs), acc.dtype)


def _fold(fn):
    def run(*xs):
        acc = xs[0]
        for x in xs[1:]:
            acc = fn(acc, x)
        return acc
    return run


_ELEMENTWISE = {"add": _fold(torch.add), "subtract": _fold(torch.sub),
                "product": _fold(torch.mul), "average": _average,
                "max": _fold(torch.maximum)}


@dataclasses.dataclass
class ElementWiseVertex(GraphVertex):
    """Pointwise combine, left to right: Add, Subtract, Product, Average
    (the sum times ``1/n``) or Max (JAX ``ElementWiseVertex`` :88)."""
    op: str = "Add"

    def output_type(self, itypes):
        return itypes[0]

    def build(self, ctx, itypes):
        fn = _ELEMENTWISE.get(self.op.lower())
        if fn is None:
            raise ValueError(f"unknown element-wise op {self.op!r}; known: "
                             f"Add, Subtract, Product, Average, Max")
        return VertexFn(fn, _cnn(itypes))


@dataclasses.dataclass
class SubsetVertex(GraphVertex):
    """Features ``from_idx`` to ``to_idx`` inclusive (JAX
    ``SubsetVertex`` :122)."""
    from_idx: int = 0
    to_idx: int = 0

    def output_type(self, itypes):
        n = self.to_idx - self.from_idx + 1
        return InputType(itypes[0].kind, (n,) + itypes[0].dims[1:])

    def build(self, ctx, itypes):
        lo, hi = self.from_idx, self.to_idx + 1
        if itypes[0].kind == "rnn":
            return VertexFn(lambda x: x[..., lo:hi], False)
        return VertexFn(lambda x: x[:, lo:hi], _cnn(itypes))


@dataclasses.dataclass
class ScaleVertex(GraphVertex):
    """``x * scale_factor`` (JAX ``ScaleVertex`` :161)."""
    scale_factor: float = 1.0

    def output_type(self, itypes):
        return itypes[0]

    def build(self, ctx, itypes):
        c = self.scale_factor
        return VertexFn(lambda x: x * _scalar_in(c, x.dtype), _cnn(itypes))


@dataclasses.dataclass
class ShiftVertex(GraphVertex):
    """``x + shift_factor`` (JAX ``ShiftVertex`` :175)."""
    shift_factor: float = 0.0

    def output_type(self, itypes):
        return itypes[0]

    def build(self, ctx, itypes):
        c = self.shift_factor
        return VertexFn(lambda x: x + _scalar_in(c, x.dtype), _cnn(itypes))


def _l2_normalized(x, dims, eps: float):
    norm = (x * x).sum(dim=dims, keepdim=True).sqrt()
    return x / (norm + _scalar_in(eps, x.dtype))


@dataclasses.dataclass
class DotProductVertex(GraphVertex):
    """The batch dot product of two ff or rnn inputs over the feature
    axis, ``(B, 1)`` or ``(B, T, 1)``, each input L2-normalized first with
    ``normalize`` (JAX ``DotProductVertex`` :189)."""
    normalize: bool = False

    def output_type(self, itypes):
        if itypes[0].kind == "ff":
            return InputType.feed_forward(1)
        if itypes[0].kind == "rnn":
            return InputType.recurrent(1, itypes[0].dims[1])
        raise ValueError(f"DotProductVertex supports ff/rnn inputs, not "
                         f"{itypes[0].kind!r}")

    def build(self, ctx, itypes):
        self.output_type(itypes)
        normalize = self.normalize
        axis = _feature_axis(itypes)

        def dot(a, b):
            if normalize:
                a = _l2_normalized(a, (axis,), 1e-12)
                b = _l2_normalized(b, (axis,), 1e-12)
            return (a * b).sum(dim=axis, keepdim=True)
        return VertexFn(dot, False)


@dataclasses.dataclass
class L2NormalizeVertex(GraphVertex):
    """``x / (||x|| + eps)`` over every non-batch axis, or over
    ``dimensions`` of the logical NCHW tensor (JAX ``L2NormalizeVertex``
    :225)."""
    eps: float = 1e-8
    dimensions: Optional[Tuple[int, ...]] = None

    def output_type(self, itypes):
        return itypes[0]

    def build(self, ctx, itypes):
        dims = tuple(self.dimensions) if self.dimensions is not None \
            else tuple(range(1, 1 + len(itypes[0].dims)))
        eps = self.eps
        return VertexFn(lambda x: _l2_normalized(x, dims, eps),
                        _cnn(itypes))


#: the JSON ``@class`` names of the vertices
VERTEX_TYPES: Dict[str, type] = {c.__name__: c for c in [
    MergeVertex, ElementWiseVertex, SubsetVertex, ScaleVertex, ShiftVertex,
    L2NormalizeVertex, DotProductVertex]}


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
    regularization: Sequence[Regularization] = ()
    dtype: str = "float32"
    mixed_precision: Optional[MixedPrecision] = None

    def to_json(self) -> str:
        """The JAX package's JSON (JAX :276-290); the port's graph body is
        the JAX graph's NCHW layout."""
        return json.dumps({
            "seed": self.seed, "dtype": self.dtype,
            "cnn_data_format": "NCHW",
            "mixed_precision": (self.mixed_precision.to_json()
                                if self.mixed_precision else None),
            "updater": self.updater.to_json(),
            "regularization": [r.to_json() for r in self.regularization],
            "inputs": self.inputs,
            "input_types": [t.to_json() for t in self.input_types],
            "outputs": self.outputs,
            "nodes": [{"name": n.name,
                       "kind": "layer" if isinstance(n.op, BaseLayer)
                       else "vertex",
                       "op": n.op.to_json(), "inputs": n.inputs}
                      for n in self.nodes],
        }, indent=1)

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        """A configuration from its JSON (JAX :292-300). A graph the JAX
        package ran in its NHWC layout reads the same, its weights being
        the same arrays, but for a layer after a cnn input's flatten,
        whose rows follow the layout: such a graph is refused by name."""
        d = json.loads(s)
        nodes = []
        for nd in d["nodes"]:
            op = BaseLayer.from_json(nd["op"]) if nd["kind"] == "layer" \
                else GraphVertex.from_json(nd["op"])
            nodes.append(_Node(nd["name"], op, list(nd["inputs"])))
        if d.get("cnn_data_format", "NCHW") == "NHWC":
            _refuse_nhwc_flatten(d["inputs"], [InputType.from_json(t) for t
                                                in d["input_types"]], nodes)
        return ComputationGraphConfiguration(
            inputs=list(d["inputs"]),
            input_types=[InputType.from_json(t) for t in d["input_types"]],
            nodes=nodes, outputs=list(d["outputs"]), seed=d["seed"],
            updater=IUpdater.from_json(d["updater"]),
            regularization=[Regularization.from_json(r)
                            for r in d.get("regularization", [])],
            dtype=d.get("dtype", "float32"),
            mixed_precision=MixedPrecision.from_json(
                d.get("mixed_precision")))


def _refuse_nhwc_flatten(inputs, input_types, nodes) -> None:
    """Raise where a layer flattens a cnn input in a graph whose JSON
    names the NHWC layout: the dense rows of the JAX package's (h, w, c)
    flatten are not the port's (c, h, w)."""
    types = dict(zip(inputs, input_types))
    for node in nodes:
        itypes = [types[i] for i in node.inputs]
        if isinstance(node.op, BaseLayer):
            itype = _adapt_itype(itypes[0], node.op, node.name)
            if itype is not itypes[0]:
                raise NotImplementedError(
                    f"node {node.name!r} flattens a cnn input in a graph "
                    f"the JAX package ran NHWC: its rows in the port's NCHW "
                    f"order are not ported yet (ROADMAP queue 1 item 1)")
            types[node.name] = node.op.output_type(itype)
        else:
            types[node.name] = node.op.output_type(itypes)


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
                  "mixed_precision": p._mixed_precision,
                  "regularization": p._regularization()}
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
    one tensor per graph output (a loss head's pre-activation logits).
    ``fused`` maps each fused BN node to its ReLU node."""

    def __init__(self, conf: ComputationGraphConfiguration,
                 modules: Dict[str, nn.Module],
                 types: Dict[str, InputType], fused: Dict[str, str],
                 flatten: Sequence[str] = ()):
        super().__init__(modules)
        self.conf = conf
        self.types = types
        self.fused = fused
        #: layer nodes whose cnn input is flattened first (NCHW order)
        self.flatten = frozenset(flatten)

    def activations(self, *inputs, unfused: bool = False
                    ) -> Dict[str, torch.Tensor]:
        """Every input's and node's value. ``unfused``: a fused BN node's
        value is its output before the ReLU, and its ReLU node applies
        the ReLU (the values the JAX graph names)."""
        vals = {}
        for name, itype, x in zip(self.conf.inputs, self.conf.input_types,
                                  inputs):
            if itype.kind == "cnn":
                x = x.contiguous(memory_format=torch.channels_last)
            vals[name] = x
        relu_of = {act: bn for bn, act in self.fused.items()} \
            if unfused else {}
        for node in self.conf.nodes:
            args = [vals[i] for i in node.inputs]
            if node.name in self.flatten:
                args = [args[0].reshape(args[0].shape[0], -1)]
            if node.name in relu_of:
                vals[node.name] = torch.relu(args[0])
            elif unfused and node.name in self.fused:
                vals[node.name] = self[node.name](*args, relu=False)
            else:
                vals[node.name] = self[node.name](*args)
        return vals

    def forward(self, *inputs):
        vals = self.activations(*inputs)
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
    flatten = []
    for index, node in enumerate(conf.nodes):
        ctx.node = index
        itypes = [types[i] for i in node.inputs]
        if isinstance(node.op, BaseLayer):
            itype = _adapt_itype(itypes[0], node.op, node.name)
            if itype is not itypes[0]:
                flatten.append(node.name)
            mod = node.op.build(ctx, itype)
            otype = node.op.output_type(itype)
            if isinstance(mod, BatchNorm):
                mod.relu = node.name in fused
            if node.name in passthrough:
                mod = nn.Identity()
        else:
            otype = node.op.output_type(itypes)
            mod = node.op.build(ctx, itypes)
        modules[node.name] = mod
        types[node.name] = otype
    return GraphModule(conf, modules, types, fused, flatten)


def _is_head(mod: nn.Module) -> bool:
    return getattr(mod, "is_loss_head", False)


def _head_output(model: GraphModule, name: str,
                 z: torch.Tensor) -> torch.Tensor:
    """A graph output as ``output()`` returns it: a loss head's output,
    contiguous NCHW for cnn."""
    mod = model[name]
    if _is_head(mod):
        z = mod.output(z)
    return z.contiguous() if model.types[name].kind == "cnn" else z


class ServingGraph:
    """A ``ComputationGraph``'s serving executor (the JAX inference
    SameDiff's place in ``serving_spec``): a ``GraphModule`` built from
    the configuration on the network's device, in inference mode, with
    its own parameters and batch-norm running statistics (one more
    parameter set on the device: for ResNet-50, 25.6 M float32
    parameters and 53 layers' statistics, about 102 MB). :meth:`sync`
    copies the network's current values into it; ``output`` runs the
    forward in the configuration's dtype with the running statistics
    and returns what ``ComputationGraph.output`` returns, by output
    name."""

    def __init__(self, net: "ComputationGraph"):
        net._require_init()
        self._net = net
        self.conf = net.conf
        self.device = net.device
        self.model = _build_graph(net.conf, net.device).eval()
        self.model.requires_grad_(False)
        self._dtype = torch_dtype(net.conf.dtype)
        self._types = dict(zip(net.conf.inputs, net.conf.input_types))

    def infer_shape(self, name: str) -> Tuple[int, ...]:
        """An input's shape, -1 for the batch dim (NCHW for cnn)."""
        return self._types[name].placeholder_shape()

    def sync(self) -> None:
        src = self._net.model.state_dict()
        with torch.no_grad():
            for k, t in self.model.state_dict().items():
                t.copy_(src[k])

    def output(self, placeholders, outputs: Sequence[str]
               ) -> Dict[str, torch.Tensor]:
        """``outputs`` by name for the inputs ``placeholders`` (arrays or
        tensors, by input name)."""
        xs = [torch.as_tensor(placeholders[n]).to(
            device=self.device, dtype=self._dtype) for n in self.conf.inputs]
        with torch.no_grad():
            vals = self.model.activations(*xs)
        return {o: _head_output(self.model, o, vals[o]) for o in outputs}


def _loss_heads(conf: ComputationGraphConfiguration,
                model: GraphModule) -> List[str]:
    """The loss heads in the JAX package's label order: graph outputs
    first, then any other head in node order."""
    heads = [n for n in conf.outputs if _is_head(model[n])]
    return heads + [n.name for n in conf.nodes if n.name not in heads
                    and _is_head(model[n.name])]


class ComputationGraph(window.StepOwner):
    def __init__(self, conf: ComputationGraphConfiguration):
        self.conf = conf
        self.model: Optional[GraphModule] = None
        self.device: Optional[torch.device] = None
        self.training_config: Optional[TrainingConfig] = None
        self._names: List[str] = []
        self._params: List[nn.Parameter] = []
        self._heads: List[str] = []
        self._head_inputs: List[str] = []
        self._updater_state = None
        self._score = float("nan")
        self._changed()

    def init(self, device: DeviceLike = None) -> "ComputationGraph":
        """Build the network on ``device`` (the CUDA card unless
        ``device="cpu"``)."""
        self.device = default_device(device)
        self.model = _build_graph(self.conf, self.device)
        named = list(self.model.named_parameters())
        self._names = [n for n, _ in named]
        self._params = [p for _, p in named]
        self._heads = _loss_heads(self.conf, self.model)
        inputs = {n.name: n.inputs[0] for n in self.conf.nodes}
        self._head_inputs = [inputs[h] for h in self._heads]
        self.training_config = TrainingConfig(
            updater=self.conf.updater,
            data_set_feature_mapping=list(self.conf.inputs),
            data_set_label_mapping=[f"labels_{h}" for h in self._heads],
            regularization=self.conf.regularization,
            mixed_precision=self.conf.mixed_precision)
        self._updater_state = None
        self._changed()
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
    # inference
    def _activations(self, inputs, training: bool, unfused: bool):
        """Every value of a forward in the configuration's dtype, under
        no_grad: with the running statistics (``training=False``), or with
        the batch statistics and the running ones left as they are."""
        self._require_init()
        self.model.train(training)
        dtype = torch_dtype(self.conf.dtype)
        xs = [self._on_device(x, dtype) for x in inputs]
        with torch.no_grad(), running_stats_frozen(self.model), \
                self._call_rng(training):
            return self.model.activations(*xs, unfused=unfused)

    def output(self, *inputs, training: bool = False) -> List[torch.Tensor]:
        """The forward, one tensor per graph output (NCHW for cnn), each
        loss head's activation applied. ``training=True`` normalizes with
        the batch statistics and leaves the running statistics as they
        are, as the JAX package's functional training forward does."""
        vals = self._activations(inputs, training, unfused=False)
        return [_head_output(self.model, o, vals[o])
                for o in self.conf.outputs]

    def feed_forward(self, *inputs, training: bool = False
                     ) -> Dict[str, torch.Tensor]:
        """The value of every input and every named vertex (JAX
        ``ComputationGraph.feed_forward``): a fused BN node's value before
        its ReLU, a loss head's after its activation; cnn values are
        logical NCHW."""
        vals = self._activations(inputs, training, unfused=True)
        return {n: _head_output(self.model, n, v) if n in self.model else v
                for n, v in vals.items()}

    # ------------------------------------------------------------------
    # the train step (window.StepOwner)
    def _grad_step(self, names, ph):
        """The gradient half of the train step: forward on the bound
        batch ``ph`` (inputs and labels by name, in the compute dtype),
        the loss heads' losses summed in float32, the backward into the
        float32 masters (the trainables ``names``, all of them). Returns
        the (unscaled) loss and the gradients, on the device."""
        tc = self.training_config
        mp = tc.mixed_precision
        self.model.train()
        xs = [ph[n] for n in tc.data_set_feature_mapping]
        ys = [ph[n] for n in tc.data_set_label_mapping]
        with torch.enable_grad(), loss_ops.softmax_dtype_scope(
                mp.softmax_dtype if mp is not None else None):
            vals = self.model.activations(*xs)
            loss = sum(self.model[h].loss(vals[h], y, vals[i]).float()
                       for h, i, y in zip(self._heads, self._head_inputs,
                                          ys))
            del vals
        scale = mp.loss_scale if mp is not None else None
        grads = torch.autograd.grad(loss * scale if scale else loss,
                                    self._params, allow_unused=True,
                                    materialize_grads=True)
        if scale:
            grads = [g / scale for g in grads]
        return loss.detach(), list(grads)

    def _masters(self, names) -> List[nn.Parameter]:
        """Every parameter (the graph trains all of them)."""
        return self._params

    def _fit_state(self):
        if self._updater_state is None:
            self._updater_state = self.training_config.updater.init(
                self._params)
            self._changed()
        return self._names, self._updater_state

    def _prep_placeholders(self, batch) -> Dict[str, torch.Tensor]:
        """A named batch on the device in the compute dtype, cast once
        here (the step itself copies nothing to the device)."""
        cdt = self.compute_dtype
        return {n: self._on_device(v, cdt) for n, v in batch.items()}

    def _placeholder_dtype(self, name: str, value) -> torch.dtype:
        return self.compute_dtype

    def warmup_restore_set(self, names, state) -> List[torch.Tensor]:
        """What a train step writes in place: every parameter, its
        updater state and every buffer of the module (the batch norms'
        running statistics, the center-loss centers)."""
        return self._params + [t for s in state for t in s] + \
            list(self.model.buffers())

    def _refuse_random_ops(self) -> None:
        """None to refuse: the graph's one random op is dropout, which the
        tiers take."""

    # ------------------------------------------------------------------
    def fit(self, data, labels=None, epochs: int = 1, batch_size: int = 32,
            listeners: Sequence = (), fused_steps: Optional[int] = None,
            accum_steps: Optional[int] = None,
            sentinel: Optional[bool] = None) -> History:
        """Train on an iterator of (features, labels) batches or
        ``DataSet``s (e.g. a ``DeviceCachedIterator``), or on a
        single-input feature array with ``labels=``, in batches of
        ``batch_size``. ``fused_steps`` sets the config's K steps a
        dispatch for this and later fits. The tier is SameDiff's
        (``autodiff/window.py``): the scanned epoch with no listeners,
        ``fused_steps <= 1`` and an iterator with ``stacked_batches``;
        fused windows of K steps when K > 1 or ``accum_steps`` > 1; else
        one step a batch. ``accum_steps`` and ``sentinel`` set the
        config's gradient accumulation and divergence sentinel for this
        and later fits. ``listeners`` get each step's loss in bursts."""
        self._require_init()
        tc = self.training_config
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
        history = window.fit(self, data, epochs, listeners)
        self._score = history.final_loss()
        return history

    def score(self) -> float:
        """The last fit's final epoch loss."""
        return self._score

    def serving_spec(self):
        """The serving contract (JAX ``ComputationGraph.serving_spec``):
        ``(executor, inputs, outputs, sync)`` with a new
        :class:`ServingGraph`, the configuration's input names, its
        output names (served as ``output()`` returns them) and the
        executor's ``sync``."""
        self._require_init()
        serve = ServingGraph(self)
        return (serve, list(self.conf.inputs), list(self.conf.outputs),
                serve.sync)

    def params(self) -> Dict[str, np.ndarray]:
        """Parameters and batch-norm running statistics under the JAX
        package's names and layouts (conv weights HWIO)."""
        self._require_init()
        return params_to_jax(self.model.state_dict())

    def num_params(self) -> int:
        self._require_init()
        return sum(p.numel() for p in self._params)

    def summary(self) -> str:
        """The vertex table, as the JAX package prints it."""
        lines = [f"ComputationGraph: {len(self.conf.nodes)} vertices, "
                 f"inputs {list(self.conf.inputs)}, outputs "
                 f"{list(self.conf.outputs)}, "
                 f"{self.num_params() if self.model is not None else '?'} "
                 f"params"]
        for node in self.conf.nodes:
            lines.append(f"  {node.name:<24} {type(node.op).__name__:<28} "
                         f"<- {', '.join(node.inputs)}")
        return "\n".join(lines)

    # -- evaluation and serde ------------------------------------------
    def evaluate(self, iterator, evaluation=None):
        """Stream ``output`` over an iterator of (features, labels)
        batches or ``DataSet``s into ``evaluation`` (an ``Evaluation`` if
        None): the first output against the first labels, as the JAX
        graph does. Returns the evaluation."""
        from deeplearning4j_tpu_torch.evaluation import Evaluation
        ev = evaluation if evaluation is not None else Evaluation()
        if hasattr(iterator, "reset"):
            iterator.reset()
        for batch in iterator:
            if hasattr(batch, "features"):
                feats, labs = batch.features, batch.labels
            else:
                feats, labs = batch
            feats = feats if isinstance(feats, (list, tuple)) else [feats]
            labs = labs if isinstance(labs, (list, tuple)) else [labs]
            ev.eval(labs[0], self.output(*feats)[0])
        return ev

    def save(self, path, include_updater_state: bool = True) -> None:
        """The JAX ModelSerializer zip (``nn/model_serde.py``): the
        configuration's JSON, the parameters and running statistics under
        the JAX names and layouts, the updater state's leaves, the
        iteration."""
        from deeplearning4j_tpu_torch.nn.model_serde import save_graph_zip
        self._require_init()
        save_graph_zip(path, self, include_updater_state)

    @staticmethod
    def load(path, device: DeviceLike = None) -> "ComputationGraph":
        """A network from a zip either package wrote, built on ``device``
        (the CUDA card unless ``device="cpu"``)."""
        from deeplearning4j_tpu_torch.nn.model_serde import (read_net_zip,
                                                             restore_net_state)
        conf_json, arrays, leaves, iteration = read_net_zip(path)
        net = ComputationGraph(
            ComputationGraphConfiguration.from_json(conf_json)).init(device)
        return restore_net_state(net, arrays, leaves, iteration)

    # -- checkpointing (checkpoint/) --------------------------------------
    def capture_training_state(self, epoch: int = 0, normalizer=None):
        """A host snapshot for the checkpoint manager
        (``checkpoint.capture_training_state``)."""
        from deeplearning4j_tpu_torch.checkpoint import capture_training_state
        return capture_training_state(self, epoch=epoch,
                                      normalizer=normalizer)

    def restore_training_state(self, state, strict: bool = True):
        """Copy a ``TrainingState`` into this initialized graph."""
        from deeplearning4j_tpu_torch.checkpoint import restore_training_state
        return restore_training_state(self, state, strict=strict)
