"""TensorFlow frozen-GraphDef -> SameDiff importer.

Counterpart of ``deeplearning4j_tpu/modelimport/tf_import.py``
(``TFImporter`` :121, ``emit`` :253, ``_static_shape`` :270,
``_import_node`` :290, the mappers :406-888, ``import_tf_graph`` :978,
``supported_tf_ops`` :1003): walk ``GraphDef.node`` in topological order,
resolve ``Const`` / ``Placeholder`` / control inputs (``^node``) / ``name:i``
output refs, and map each NodeDef onto the port's registry ops.

As in the JAX importer, every structural tensor (Reshape shapes, reduce
axes, StridedSlice specs, Range and Fill dims) is folded at import time and
becomes a static attribute; a node whose inputs are all constants is folded
by running the port's own op on CPU tensors (so folded values have the
JAX ops' dtypes); ``Shape`` nodes read the static shapes flowing through the
import (``SDVariable.shape``, a run on the ``meta`` device); control inputs
are dropped, every emitted op being pure. Constants are CONSTANTs unless
``trainable`` makes them VARIABLEs (``"auto"``: floating constants of rank
1 or more, the fine-tuning import).

The port maps every TF op of the JAX importer whose registry op it has
(:func:`supported_tf_ops`). Any other op raises :class:`TFImportError`
naming the ROADMAP item that ports it: the registry's other ops are queue 1
item 5, TF2 functional control flow (``While``/``If`` and their
``FunctionDef`` bodies) waits for SameDiff's ``while_loop``/``cond``,
queue 1 item 3.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
from deeplearning4j_tpu_torch.autodiff.variable import SDVariable
from deeplearning4j_tpu_torch.environment import DeviceLike
from deeplearning4j_tpu_torch.modelimport.tf_pb import (GraphDef, NodeDef,
                                                        tf_dtype_to_np)
from deeplearning4j_tpu_torch.ops import registry

_OPS_ITEM = "ROADMAP queue 1 item 5"
_CONTROL_FLOW = ("While", "StatelessWhile", "If", "StatelessIf")


class TFImportError(ValueError):
    pass


class _Val:
    """One TF tensor during import: a graph variable and/or a folded
    numpy constant (structural values keep the constant side)."""

    __slots__ = ("var", "const", "_name")

    def __init__(self, var=None, const=None, name=""):
        self.var = var
        self.const = const
        self._name = name

    @property
    def is_const(self):
        return self.const is not None


def _split_ref(ref: str) -> Tuple[str, int]:
    """A plain GraphDef tensor ref -> (node, output index): 'node' ->
    (node, 0), 'node:2' -> (node, 2). The named-argument form ('node:z:1')
    belongs to FunctionDef bodies, which the port does not import yet."""
    parts = ref.split(":")
    if len(parts) == 2 and parts[1].isdigit():
        return parts[0], int(parts[1])
    if len(parts) == 1:
        return ref, 0
    raise TFImportError(
        f"named output-arg ref {ref!r} belongs to a FunctionDef body; "
        f"functional control flow is not ported yet (ROADMAP queue 1 item "
        f"3); plain GraphDef refs are 'node' or 'node:<int>'")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.float().numpy().astype(tf_dtype_to_np(14))
    return t.numpy()


class TFImporter:
    """Imports one GraphDef; see :func:`import_tf_graph`."""

    def __init__(self, graph: GraphDef,
                 trainable: Union[None, str, Callable] = None,
                 input_shapes: Optional[Dict[str, Sequence[int]]] = None,
                 device: DeviceLike = None):
        self.graph = graph
        self.sd = SameDiff(device=device)
        self.input_shapes = dict(input_shapes or {})
        self._tensors: Dict[Tuple[str, int], _Val] = {}
        self._nodes: Dict[str, NodeDef] = {n.name: n for n in graph.nodes}
        if trainable == "auto":
            self._trainable = lambda name, arr: (
                np.issubdtype(arr.dtype, np.floating) and arr.ndim >= 1)
        elif callable(trainable):
            self._trainable = trainable
        else:
            self._trainable = lambda name, arr: False
        self.placeholder_names: List[str] = []
        self.variable_names: List[str] = []
        #: PlaceholderWithDefault nodes bound to their constant default
        self.placeholder_defaults: Dict[str, np.ndarray] = {}
        #: placeholders with no static shape in the pb that input_shapes=
        #: did not pin (shape-math errors name them)
        self.underspecified_placeholders: Dict[
            str, Optional[Sequence[int]]] = {}

    # ------------------------------------------------------------------
    def run(self) -> SameDiff:
        if self.graph.functions:
            raise TFImportError(
                f"the GraphDef's function library holds "
                f"{sorted(self.graph.functions)[:3]}: FunctionDef bodies "
                f"(TF2 While/If) are not ported yet (ROADMAP queue 1 item 3)")
        for node in self._topo_order():
            try:
                self._import_node(node)
            except TFImportError:
                raise
            except Exception as e:
                raise TFImportError(
                    f"while importing node {node.op} {node.name!r}: {e}") \
                    from e
        return self.sd

    def _topo_order(self) -> List[NodeDef]:
        """Kahn topo sort on data deps (GraphDef node order is arbitrary)."""
        indeg: Dict[str, int] = {}
        consumers: Dict[str, List[str]] = {}
        for n in self.graph.nodes:
            deps = {i.lstrip("^").split(":")[0] for i in n.inputs}
            deps = {d for d in deps if d in self._nodes and d != n.name}
            indeg[n.name] = len(deps)
            for d in deps:
                consumers.setdefault(d, []).append(n.name)
        ready = [n.name for n in self.graph.nodes if indeg[n.name] == 0]
        order: List[NodeDef] = []
        seen = set()
        while ready:
            nm = ready.pop()
            if nm in seen:
                continue
            seen.add(nm)
            order.append(self._nodes[nm])
            for c in consumers.get(nm, []):
                indeg[c] -= 1
                if indeg[c] == 0:
                    ready.append(c)
        if len(order) != len(self.graph.nodes):
            stuck = [n for n in indeg if n not in seen]
            raise TFImportError(f"graph has a dataflow cycle (or v1 control "
                                f"flow frames): unplaced nodes {stuck[:5]}")
        return order

    # ------------------------------------------------------------------
    # input resolution
    def _resolve(self, ref: str) -> _Val:
        key = _split_ref(ref)
        try:
            return self._tensors[key]
        except KeyError:
            raise TFImportError(
                f"input {ref!r} not produced by any imported node") from None

    def _ins(self, node: NodeDef) -> List[_Val]:
        return [self._resolve(r) for r in node.inputs if not r.startswith("^")]

    def _set(self, name: str, outs: Sequence[_Val]):
        for i, v in enumerate(outs):
            self._tensors[(name, i)] = v

    def _materialize(self, v: _Val) -> SDVariable:
        """Graph variable for a value; folded constants become CONSTANTs
        at their first data use."""
        if v.var is None:
            v.var = self.sd.constant(np.asarray(v.const),
                                     name=v._name or "imported_const")
        return v.var

    # static helpers for structural args -------------------------------
    def _const_np(self, v: _Val, what: str) -> np.ndarray:
        if not v.is_const:
            raise TFImportError(
                f"{what} must be trace-time constant (derived from consts "
                f"and static shapes); got a data-dependent tensor")
        return np.asarray(v.const)

    def _ints(self, v: _Val, what: str) -> Tuple[int, ...]:
        return tuple(int(x) for x in self._const_np(v, what).reshape(-1))

    def _int1(self, v: _Val, what: str) -> int:
        return int(self._const_np(v, what).reshape(()))

    # ------------------------------------------------------------------
    def emit(self, op_name: str, ins: Sequence[_Val], attrs: Dict,
             name: str, n_outputs: int = 1) -> List[_Val]:
        """Record a registry op, or fold it when every input is constant:
        the port's op runs on CPU tensors and its results come back as
        numpy arrays in the op's dtypes."""
        if all(v.is_const for v in ins):
            fn = registry.get_op(op_name).fn
            with torch.no_grad():
                res = fn(*[torch.from_numpy(np.array(v.const)) for v in ins],
                         **attrs)
            res = res if isinstance(res, (tuple, list)) else [res]
            return [_Val(const=_to_numpy(r), name=f"{name}:{i}" if i else name)
                    for i, r in enumerate(res)]
        vars_ = [self._materialize(v) for v in ins]
        out = self.sd.invoke(op_name, vars_, attrs=attrs, name=name,
                             n_outputs=n_outputs)
        outs = out if isinstance(out, list) else [out]
        return [_Val(var=o) for o in outs]

    def _static_shape(self, v: _Val, node_name: str) -> Tuple[int, ...]:
        if v.is_const:
            return tuple(np.asarray(v.const).shape)
        shape = v.var.shape
        if shape is None or any(d is None or d < 0 for d in shape):
            hint = ""
            if self.underspecified_placeholders:
                ex = ", ".join(
                    f"{n!r}: (batch, ...)"
                    for n in sorted(self.underspecified_placeholders))
                hint = (f" — this graph's placeholders carry no static "
                        f"shape in the pb (a normal frozen-graph export "
                        f"artifact): pass input_shapes={{{ex}}} with "
                        f"concrete dims")
            raise TFImportError(
                f"Shape node {node_name!r}: input has non-static shape "
                f"{shape}{hint}")
        return tuple(shape)

    # ------------------------------------------------------------------
    def _import_node(self, node: NodeDef):
        op = node.op
        if op == "NoOp":
            return
        if op == "Const":
            arr = node.attrs["value"].tensor
            if self._trainable(node.name, arr):
                var = self.sd.var(node.name, value=arr,
                                  dtype=str(arr.dtype))
                self.variable_names.append(var.name)
                self._set(node.name, [_Val(var=var)])
            else:
                self._set(node.name, [_Val(const=arr, name=node.name)])
            return
        if op == "PlaceholderWithDefault":
            # a constant default imports as that constant (frozen-graph
            # semantics: keep_prob flags and the like); a data-dependent
            # default falls through to a real placeholder
            ins = self._ins(node)
            if ins and ins[0].is_const:
                self.placeholder_defaults[node.name] = np.asarray(ins[0].const)
                self._set(node.name, [_Val(const=np.asarray(ins[0].const),
                                           name=node.name)])
                return
        if op in ("Placeholder", "PlaceholderWithDefault"):
            a = node.attr("shape")
            shape = self.input_shapes.get(node.name)
            if shape is None and a is not None:
                shape = a.shape          # auto-derive from the shape attr
            if shape is None or any(d is None or d < 0 for d in shape):
                self.underspecified_placeholders[node.name] = shape
            dt = node.attr("dtype")
            np_dt = tf_dtype_to_np(dt.type) if dt else np.dtype(np.float32)
            ph = self.sd.placeholder(node.name, shape=shape, dtype=str(np_dt))
            self.placeholder_names.append(ph.name)
            self._set(node.name, [_Val(var=ph)])
            return

        mapper = _MAPPERS.get(op)
        if mapper is None:
            item = ("ROADMAP queue 1 item 3: SameDiff's while_loop/cond"
                    if op in _CONTROL_FLOW else _OPS_ITEM)
            raise TFImportError(
                f"unmapped TF op {op!r} (node {node.name!r}); the port maps "
                f"{len(_MAPPERS)} ops, the rest wait for their registry ops "
                f"({item})")
        outs = mapper(self, node, self._ins(node))
        if isinstance(outs, _Val):
            outs = [outs]
        self._set(node.name, outs)


# ---------------------------------------------------------------------------
# mapper table (the JAX importer's, for the registry ops the port has)
_MAPPERS: Dict[str, Callable] = {}


def _mapper(*tf_names):
    def deco(fn):
        for n in tf_names:
            _MAPPERS[n] = fn
        return fn
    return deco


def _refuse(node, what: str):
    raise TFImportError(f"{node.op} node {node.name!r}: {what} is not ported "
                        f"yet ({_OPS_ITEM})")


def _attr_b(node, name, default=False):
    a = node.attr(name)
    return a.b if a is not None else default


def _attr_i(node, name, default=0):
    a = node.attr(name)
    return a.i if a is not None else default


def _attr_f(node, name, default=0.0):
    a = node.attr(name)
    return a.f if a is not None else default


def _attr_s(node, name, default=""):
    a = node.attr(name)
    return a.s if a is not None else default


def _attr_ilist(node, name, default=()):
    a = node.attr(name)
    return list(a.list["i"]) if a is not None else list(default)


def _attr_type(node, name, default: int):
    """DataType attr (Cast DstT, ArgMax output_type, Shape out_type, ...):
    AttrValue.type (field 6), as TF writes it, or a plain int (field 3)."""
    a = node.attr(name)
    if a is None:
        return default
    return a.type or a.i or default


# --- passthrough / identity ------------------------------------------------
@_mapper("Identity", "Snapshot", "PreventGradient", "CheckNumerics",
         "EnsureShape")
def _m_identity(imp, node, ins):
    return ins[0]


@_mapper("IdentityN")
def _m_identity_n(imp, node, ins):
    return list(ins)


# --- elementwise -----------------------------------------------------------
_UNARY = {"Relu": "relu", "Tanh": "tanh", "Rsqrt": "rsqrt", "Neg": "neg",
          "Erf": "erf"}
_BINARY = {"Add": "add", "AddV2": "add", "Sub": "subtract",
           "Mul": "multiply", "Div": "divide", "RealDiv": "divide",
           "SquaredDifference": "squaredsubtract", "Greater": "greater"}


def _make_elementwise(reg_name):
    def m(imp, node, ins):
        return imp.emit(reg_name, ins, {}, node.name)
    return m


for _tf, _reg in {**_UNARY, **_BINARY}.items():
    _MAPPERS[_tf] = _make_elementwise(_reg)


@_mapper("Softmax")
def _m_softmax(imp, node, ins):
    return imp.emit("softmax", ins, {"axis": -1}, node.name)


@_mapper("Select", "SelectV2")
def _m_select(imp, node, ins):
    return imp.emit("where_op", ins, {}, node.name)


# --- matmul family ---------------------------------------------------------
@_mapper("MatMul")
def _m_matmul(imp, node, ins):
    return imp.emit("matmul", ins,
                    {"transpose_a": _attr_b(node, "transpose_a"),
                     "transpose_b": _attr_b(node, "transpose_b")}, node.name)


@_mapper("BatchMatMul", "BatchMatMulV2", "BatchMatMulV3")
def _m_batch_matmul(imp, node, ins):
    return imp.emit("batched_matmul", ins,
                    {"transpose_a": _attr_b(node, "adj_x"),
                     "transpose_b": _attr_b(node, "adj_y")}, node.name)


@_mapper("Einsum")
def _m_einsum(imp, node, ins):
    return imp.emit("einsum", ins, {"equation": _attr_s(node, "equation")},
                    node.name)


@_mapper("BiasAdd")
def _m_bias_add(imp, node, ins):
    return imp.emit("bias_add", ins,
                    {"data_format": _attr_s(node, "data_format", "NHWC")},
                    node.name)


# --- conv / pool / norm ----------------------------------------------------
@_mapper("Conv2D")
def _m_conv2d(imp, node, ins):
    df = _attr_s(node, "data_format", "NHWC")
    strides = _attr_ilist(node, "strides", (1, 1, 1, 1))
    dil = _attr_ilist(node, "dilations", (1, 1, 1, 1))
    sp = (1, 2) if df == "NHWC" else (2, 3)
    return imp.emit("conv2d", ins, {
        "strides": (strides[sp[0]], strides[sp[1]]),
        "dilation": (dil[sp[0]], dil[sp[1]]),
        "padding": _attr_s(node, "padding", "SAME"),
        "data_format": df}, node.name)


def _pool(imp, node, ins, reg_name):
    df = _attr_s(node, "data_format", "NHWC")
    ks = _attr_ilist(node, "ksize", (1, 2, 2, 1))
    st = _attr_ilist(node, "strides", (1, 2, 2, 1))
    sp = (1, 2) if df == "NHWC" else (2, 3)
    return imp.emit(reg_name, ins, {
        "kernel": (ks[sp[0]], ks[sp[1]]),
        "strides": (st[sp[0]], st[sp[1]]),
        "padding": _attr_s(node, "padding", "VALID"),
        "data_format": df}, node.name)


@_mapper("MaxPool")
def _m_max_pool(imp, node, ins):
    return _pool(imp, node, ins, "max_pool2d")


@_mapper("AvgPool")
def _m_avg_pool(imp, node, ins):
    return _pool(imp, node, ins, "avg_pool2d")


@_mapper("FusedBatchNorm", "FusedBatchNormV2", "FusedBatchNormV3")
def _m_fused_batch_norm(imp, node, ins):
    outs = imp.emit("tf_fused_batch_norm", ins, {
        "epsilon": _attr_f(node, "epsilon", 1e-3),
        "data_format": _attr_s(node, "data_format", "NHWC"),
        "is_training": _attr_b(node, "is_training", False)},
        node.name, n_outputs=3)
    # V3 declares 6 outputs (y, mean, var, 3 reserve spaces); reserves are
    # only consumed by the TF-side grad op: alias them to mean/var
    return outs + [outs[1], outs[2], outs[1]]


# --- shape / structure (structural args const-folded) ----------------------
@_mapper("Shape")
def _m_shape(imp, node, ins):
    shape = imp._static_shape(ins[0], node.name)
    out_dt = tf_dtype_to_np(_attr_type(node, "out_type", 3))
    return _Val(const=np.asarray(shape, dtype=out_dt), name=node.name)


@_mapper("ShapeN")
def _m_shape_n(imp, node, ins):
    out_dt = tf_dtype_to_np(_attr_type(node, "out_type", 3))
    return [_Val(const=np.asarray(imp._static_shape(v, node.name), out_dt))
            for v in ins]


@_mapper("Size")
def _m_size(imp, node, ins):
    shape = imp._static_shape(ins[0], node.name)
    return _Val(const=np.asarray(int(np.prod(shape)), dtype=np.int32))


@_mapper("Rank")
def _m_rank(imp, node, ins):
    shape = imp._static_shape(ins[0], node.name)
    return _Val(const=np.asarray(len(shape), dtype=np.int32))


@_mapper("Reshape")
def _m_reshape(imp, node, ins):
    shape = imp._ints(ins[1], "Reshape shape")
    return imp.emit("reshape", [ins[0]], {"shape": shape}, node.name)


@_mapper("Transpose")
def _m_transpose(imp, node, ins):
    perm = imp._ints(ins[1], "Transpose perm")
    return imp.emit("permute", [ins[0]], {"axes": perm}, node.name)


@_mapper("ConcatV2")
def _m_concat_v2(imp, node, ins):
    axis = imp._int1(ins[-1], "ConcatV2 axis")
    return imp.emit("concat", ins[:-1], {"axis": axis}, node.name)


@_mapper("Concat")
def _m_concat(imp, node, ins):
    axis = imp._int1(ins[0], "Concat axis")   # legacy: axis FIRST
    return imp.emit("concat", ins[1:], {"axis": axis}, node.name)


@_mapper("Pack")
def _m_pack(imp, node, ins):
    return imp.emit("stack", ins, {"axis": _attr_i(node, "axis", 0)},
                    node.name)


@_mapper("Split")
def _m_split(imp, node, ins):
    axis = imp._int1(ins[0], "Split axis")    # (axis, value) input order
    num = _attr_i(node, "num_split", 1)
    return imp.emit("split", [ins[1]], {"num_split": num, "axis": axis},
                    node.name, n_outputs=num)


@_mapper("StridedSlice")
def _m_strided_slice(imp, node, ins):
    return imp.emit("strided_slice_masked", [ins[0]], {
        "begin": imp._ints(ins[1], "StridedSlice begin"),
        "end": imp._ints(ins[2], "StridedSlice end"),
        "strides": imp._ints(ins[3], "StridedSlice strides"),
        "begin_mask": _attr_i(node, "begin_mask"),
        "end_mask": _attr_i(node, "end_mask"),
        "ellipsis_mask": _attr_i(node, "ellipsis_mask"),
        "new_axis_mask": _attr_i(node, "new_axis_mask"),
        "shrink_axis_mask": _attr_i(node, "shrink_axis_mask")}, node.name)


@_mapper("Slice")
def _m_slice(imp, node, ins):
    begin = imp._ints(ins[1], "Slice begin")
    size = imp._ints(ins[2], "Slice size")
    return imp.emit("slice", [ins[0]], {"begin": begin, "size": size},
                    node.name)


@_mapper("Gather", "GatherV2")
def _m_gather(imp, node, ins):
    axis = imp._int1(ins[2], "Gather axis") if len(ins) > 2 else 0
    if _attr_i(node, "batch_dims", 0):
        _refuse(node, "batch_dims (the registry op gather_batch_dims)")
    return imp.emit("gather", ins[:2], {"axis": axis}, node.name)


@_mapper("OneHot")
def _m_one_hot(imp, node, ins):
    depth = imp._int1(ins[1], "OneHot depth")
    on = float(imp._const_np(ins[2], "OneHot on_value"))
    off = float(imp._const_np(ins[3], "OneHot off_value"))
    dt = node.attr("T")
    return imp.emit("one_hot", [ins[0]], {
        "depth": depth, "on_value": on, "off_value": off,
        "axis": _attr_i(node, "axis", -1),
        "dtype": str(tf_dtype_to_np(dt.type)) if dt else "float32"},
        node.name)


@_mapper("Fill")
def _m_fill(imp, node, ins):
    dims = imp._ints(ins[0], "Fill dims")
    if not ins[1].is_const:
        _refuse(node, "a Fill of a data-dependent value (the registry op "
                      "broadcast_to)")
    return _Val(const=np.full(dims, np.asarray(ins[1].const)),
                name=node.name)


@_mapper("Range")
def _m_range(imp, node, ins):
    start = imp._const_np(ins[0], "Range start")
    limit = imp._const_np(ins[1], "Range limit")
    delta = imp._const_np(ins[2], "Range delta")
    return _Val(const=np.arange(start, limit, delta), name=node.name)


@_mapper("Cast")
def _m_cast(imp, node, ins):
    dst = tf_dtype_to_np(_attr_type(node, "DstT", 1))
    return imp.emit("cast", ins, {"dtype": str(dst)}, node.name)


@_mapper("InvertPermutation")
def _m_invert_permutation(imp, node, ins):
    perm = imp._ints(ins[0], "InvertPermutation x")
    return _Val(const=np.argsort(perm).astype(np.int32), name=node.name)


# --- reductions ------------------------------------------------------------
_REDUCE = {"Mean": "reduce_mean", "Sum": "reduce_sum"}


def _make_reduce(reg_name):
    def m(imp, node, ins):
        axes_np = imp._const_np(ins[1], f"{node.op} reduction_indices")
        axes = tuple(int(x) for x in axes_np.reshape(-1))
        if axes_np.ndim > 0 and len(axes) == 0:
            return ins[0]  # TF: empty axes list = identity
        return imp.emit(reg_name, [ins[0]],
                        {"axis": axes or None,
                         "keep_dims": _attr_b(node, "keep_dims", False)},
                        node.name)
    return m


for _tf, _reg in _REDUCE.items():
    _MAPPERS[_tf] = _make_reduce(_reg)


@_mapper("ArgMax")
def _m_argmax(imp, node, ins):
    axis = imp._int1(ins[1], "ArgMax dimension")
    out = imp.emit("argmax", [ins[0]], {"axis": axis}, node.name + "/arg")
    dt = tf_dtype_to_np(_attr_type(node, "output_type", 9))
    return imp.emit("cast", out, {"dtype": str(dt)}, node.name)


# ---------------------------------------------------------------------------
def import_tf_graph(source: Union[str, bytes, GraphDef],
                    trainable: Union[None, str, Callable] = None,
                    input_shapes: Optional[Dict[str, Sequence[int]]] = None,
                    device: DeviceLike = None) -> SameDiff:
    """Import a frozen TF GraphDef (a .pb path, its bytes, or a decoded
    GraphDef) into a SameDiff graph on ``device`` (the CUDA card unless
    ``device="cpu"``).

    trainable: None (every constant stays a CONSTANT: inference), "auto"
      (floating constants of rank >= 1 become trainable VARIABLEs), or a
      predicate ``fn(node_name, np_array) -> bool``.
    input_shapes: placeholder shapes that override the pb's (concrete
      batch dims let Shape-derived reshapes fold statically).
    """
    if isinstance(source, (str, bytes)):
        graph = GraphDef.from_file(source) if isinstance(source, str) \
            else GraphDef(source)
    else:
        graph = source
    return TFImporter(graph, trainable=trainable, input_shapes=input_shapes,
                      device=device).run()


def supported_tf_ops() -> List[str]:
    """Every NodeDef op the port imports (the mapped ones, plus
    Const/Placeholder/PlaceholderWithDefault/NoOp handled inline)."""
    return sorted(set(_MAPPERS) | {"Const", "Placeholder",
                                   "PlaceholderWithDefault", "NoOp"})
