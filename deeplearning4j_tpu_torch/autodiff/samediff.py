"""SameDiff: the define-then-run autodiff graph, on PyTorch.

Counterpart of ``deeplearning4j_tpu/autodiff/samediff.py``: graph
recording (``var`` :138, ``constant`` :160, ``placeholder`` :170,
``invoke`` :299, ``OpNode`` :59), state variables (``state_var``,
``update_state``, ``state_vars_map`` :218-237), ``remat_scope`` :417, ``_prune`` :452,
``output`` :581, ``calculate_gradients`` :729 (each drawing its random
ops with the next seed, ``_seed`` :93) and ``fit`` (:1558) with
the train step of ``_build_step_parts`` :773, whose gradient half is
``_grad_step`` here and whose apply half, sentinel and accumulation are
``autodiff/step.py``; ``fit``'s tiers (per-step, fused windows, scanned
epoch) are ``autodiff/window.py``.

Where the JAX package traces the pruned graph into one jitted function
and takes ``jax.grad`` of it, the port runs the pruned op order eagerly
and takes ``torch.autograd``. Consecutive ops recorded in one
``remat_scope`` run as one ``torch.utils.checkpoint`` region (the
counterpart of the ``jax.checkpoint`` segments of ``_trace_fn`` :466):
their activations are recomputed in the backward from the region's
inputs. The train step casts float parameters, constants and
placeholders to ``MixedPrecision.compute_dtype`` at the top of the
forward, runs the loss ops under ``softmax_dtype_scope``, sums the loss
variables in float32, applies the optional loss scale, back-propagates
into the float32 masters and updates them (and the updater state) in
place.

State variables are stored VARIABLEs the updater does not train
(``trainable_params`` leaves them out): a recurrent layer's carried
state in TBPTT (``nn/multilayer.py`` ``fit_tbptt``). The train step
feeds them detached (the truncation) and, after the backward, copies
the outputs ``update_state`` declared into them in place (``copy_``),
so a captured window carries them in its static tensors from step to
step; a state variable with no declared update keeps its value.

Values live on the SameDiff's ``device``: the CUDA card unless
``device="cpu"``. ``fit`` updates the stored arrays in place;
``set_arr_for_var`` stores a new tensor, as the JAX package does, so a
tensor ``get_arr_for_var`` returned earlier (a server's pulled weights)
keeps its values. A captured fit window reads the stored arrays by
address: whatever changes one (``set_arr_for_var``, a new variable or op,
a new updater state) drops the captured windows, and the next fit
captures them again. Restoring a checkpoint (``checkpoint/state.py``)
copies into the stored tensors and keeps the windows. Not ported yet
(ROADMAP queue 1): control flow (``while_loop``/``cond``/``scan``),
``precompile``, ``exec_debug``, serde and tensor statistics.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from deeplearning4j_tpu_torch.autodiff import window
from deeplearning4j_tpu_torch.autodiff.ops_namespaces import make_namespaces
from deeplearning4j_tpu_torch.autodiff.training import History
from deeplearning4j_tpu_torch.autodiff.variable import SDVariable, VariableType
from deeplearning4j_tpu_torch.environment import DeviceLike, default_device
from deeplearning4j_tpu_torch.ops import loss as loss_ops
from deeplearning4j_tpu_torch.ops import random as random_ops
from deeplearning4j_tpu_torch.ops import registry
from deeplearning4j_tpu_torch.ops.dtypes import torch_dtype

Env = Dict[str, torch.Tensor]


@dataclasses.dataclass
class OpNode:
    """One recorded op (reference: samediff.internal.SameDiffOp)."""
    name: str                 # unique node name
    op: str                   # registry op name
    inputs: List[str]         # input variable names
    outputs: List[str]        # output variable names
    attrs: Dict[str, Any]     # static attributes
    group: Optional[str] = None  # remat group id (see SameDiff.remat_scope)


def _split_batch(batch):
    """(features, labels) lists from a DataSet-like or a (features,
    labels) batch."""
    if hasattr(batch, "features") and hasattr(batch, "labels"):
        f, l = batch.features, batch.labels
    elif isinstance(batch, (tuple, list)) and len(batch) == 2:
        f, l = batch
    else:
        raise TypeError(f"cannot interpret batch of type {type(batch)}")
    return (list(f) if isinstance(f, (list, tuple)) else [f],
            list(l) if isinstance(l, (list, tuple)) else [l])


class SameDiff(window.StepOwner):
    """Define-then-run graph executed eagerly, with autograd gradients.
    It owns its train step for the fit tiers (``window.StepOwner``)."""

    def __init__(self, device: DeviceLike = None):
        self.device = default_device(device)
        self._vars: Dict[str, SDVariable] = {}
        self._arrays: Env = {}                    # VARIABLE/CONSTANT values
        self._ops: Dict[str, OpNode] = {}
        self._op_order: List[str] = []            # creation order = topo order
        self._name_counter: Dict[str, int] = {}
        self.loss_variables: List[str] = []
        self._state_var_names: set = set()
        self._state_updates: Dict[str, str] = {}  # state var -> output
        self._n_random = 0                        # random ops recorded
        self._active_group: Optional[str] = None  # current remat_scope id
        self._group_counter = 0
        self.training_config = None
        self._updater_state = None
        self._changed()
        for ns_name, ns in make_namespaces(self).items():
            setattr(self, ns_name, ns)

    # ------------------------------------------------------------------
    # naming
    def _unique_name(self, base: str) -> str:
        if base not in self._vars and base not in self._ops:
            return base
        while True:
            i = self._name_counter.get(base, 0) + 1
            self._name_counter[base] = i
            cand = f"{base}_{i}"
            if cand not in self._vars and cand not in self._ops:
                return cand

    def _tensor(self, value, dtype=None, copy: bool = False) -> torch.Tensor:
        """``value`` on the device; ``copy`` for a stored array, which the
        updater changes in place and must not share the caller's memory."""
        t = value if isinstance(value, torch.Tensor) else torch.from_numpy(
            np.array(value, copy=True))
        return t.to(device=self.device, copy=copy and t is value,
                    dtype=None if dtype is None else torch_dtype(dtype))

    # ------------------------------------------------------------------
    # variable creation (reference: SameDiff.var/constant/placeHolder)
    def var(self, name: str = "var", shape: Optional[Sequence[int]] = None,
            dtype: str = "float32", value=None,
            weight_init=None) -> SDVariable:
        """Trainable VARIABLE. Provide ``value`` or ``shape`` (+ optional
        ``weight_init(shape) -> array``)."""
        name = self._unique_name(name)
        if value is not None:
            arr = self._tensor(value, dtype, copy=True)
        elif shape is not None:
            arr = self._tensor(weight_init(tuple(shape)), dtype, True) \
                if weight_init is not None else torch.zeros(
                    tuple(shape), dtype=torch_dtype(dtype),
                    device=self.device)
        else:
            raise ValueError("var() needs value= or shape=")
        return self._store(name, VariableType.VARIABLE, arr)

    def constant(self, value, name: str = "const",
                 dtype=None) -> SDVariable:
        return self._store(self._unique_name(name), VariableType.CONSTANT,
                           self._tensor(value, dtype, copy=True))

    def _store(self, name, kind, arr) -> SDVariable:
        v = SDVariable(self, name, kind, tuple(arr.shape),
                       str(arr.dtype).replace("torch.", ""))
        self._vars[name] = v
        self._arrays[name] = arr
        self._changed()
        return v

    def placeholder(self, name: str, shape: Optional[Sequence[int]] = None,
                    dtype: str = "float32") -> SDVariable:
        """PLACEHOLDER fed at run time; -1/None dims are batch dims."""
        name = self._unique_name(name)
        v = SDVariable(self, name, VariableType.PLACEHOLDER, None, dtype)
        v._shape = None if shape is None else tuple(
            -1 if d is None else int(d) for d in shape)
        self._vars[name] = v
        return v

    def _lift(self, value) -> SDVariable:
        """A python scalar or array as a CONSTANT variable."""
        if isinstance(value, SDVariable):
            if value.sd is not self:
                raise ValueError("variable belongs to a different SameDiff")
            return value
        return self.constant(value)

    # ------------------------------------------------------------------
    # graph access
    def variables(self) -> List[SDVariable]:
        return list(self._vars.values())

    def get_variable(self, name: str) -> SDVariable:
        return self._vars[name]

    def has_variable(self, name: str) -> bool:
        return name in self._vars

    def ops(self) -> List[OpNode]:
        return [self._ops[n] for n in self._op_order]

    def _names(self, kind: VariableType) -> List[str]:
        return [n for n, v in self._vars.items() if v.var_type == kind]

    def trainable_params(self) -> Env:
        return {n: self._arrays[n] for n in self._names(VariableType.VARIABLE)
                if n not in self._state_var_names}

    def state_var(self, name: str, value, dtype: str = "float32"
                  ) -> SDVariable:
        """A non-trainable stored variable, changed by
        :meth:`update_state` and not by the updater."""
        v = self.var(name, value=value, dtype=dtype)
        self._state_var_names.add(v.name)
        return v

    def update_state(self, state_var: Union[str, SDVariable],
                     new_value: Union[str, SDVariable]) -> None:
        """After each training step ``state_var`` takes the value of the
        graph output ``new_value``."""
        sn = state_var.name if isinstance(state_var, SDVariable) \
            else state_var
        src = new_value.name if isinstance(new_value, SDVariable) \
            else new_value
        if sn not in self._state_var_names:
            raise ValueError(f"{sn!r} is not a state var")
        self._state_updates[sn] = src
        self._changed()

    def state_vars_map(self) -> Env:
        return {n: self._arrays[n] for n in self._vars
                if n in self._state_var_names}

    def constants_map(self) -> Env:
        return {n: self._arrays[n] for n in self._names(VariableType.CONSTANT)}

    def placeholders(self) -> List[str]:
        return self._names(VariableType.PLACEHOLDER)

    def get_arr_for_var(self, name: str) -> Optional[torch.Tensor]:
        a = self._arrays.get(name)
        return None if a is None else a.detach()

    def set_arr_for_var(self, name: str, value) -> None:
        """Store ``value`` as a new tensor (never the caller's, and never
        written into the one stored before, which earlier
        ``get_arr_for_var`` callers may hold); the captured fit windows,
        which read the old one, are dropped."""
        v = self._vars[name]
        if v.var_type not in (VariableType.VARIABLE, VariableType.CONSTANT):
            raise ValueError(f"{name} is {v.var_type.value}; has no stored "
                             f"array")
        new = self._tensor(value, copy=True)
        self._arrays[name] = new
        v._shape = tuple(new.shape)
        v._dtype = str(new.dtype).replace("torch.", "")
        self._changed()

    def set_loss_variables(self, names: Sequence[Union[str, SDVariable]]):
        self.loss_variables = [n.name if isinstance(n, SDVariable) else n
                               for n in names]
        self._changed()

    def rename_variable(self, old: str, new: str) -> SDVariable:
        if new in self._vars:
            raise ValueError(f"variable {new!r} already exists")
        v = self._vars.pop(old)
        v.name = new
        self._vars[new] = v
        if old in self._arrays:
            self._arrays[new] = self._arrays.pop(old)
        for node in self._ops.values():
            node.inputs = [new if i == old else i for i in node.inputs]
            node.outputs = [new if o == old else o for o in node.outputs]
        self.loss_variables = [new if n == old else n
                               for n in self.loss_variables]
        if old in self._state_var_names:
            self._state_var_names.discard(old)
            self._state_var_names.add(new)
        self._state_updates = {
            (new if k == old else k): (new if s == old else s)
            for k, s in self._state_updates.items()}
        self._changed()
        return v

    def outputs(self) -> List[str]:
        """ARRAY variables no op consumes."""
        consumed = {i for node in self._ops.values() for i in node.inputs}
        return [n for n in self._names(VariableType.ARRAY)
                if n not in consumed]

    # ------------------------------------------------------------------
    # op recording
    def invoke(self, op_name: str, inputs: Sequence[SDVariable],
               attrs: Optional[Dict[str, Any]] = None,
               name: Optional[str] = None,
               n_outputs: int = 1) -> Union[SDVariable, List[SDVariable]]:
        """Record a registry op; returns its output variable(s)."""
        o = registry.get_op(op_name)
        node_name = self._unique_name(name or op_name)
        attrs = dict(attrs or {})
        if o.category == "random":
            self._n_random += 1
            if o.name in random_ops.PORTED_RANDOM_OPS:
                # the node's index keys its draws (JAX ``fold_in(key,
                # idx)``)
                attrs.setdefault("node", len(self._op_order))
        out_names = []
        for i in range(n_outputs):
            out_name = self._unique_name(
                node_name if n_outputs == 1 else f"{node_name}:{i}")
            self._vars[out_name] = SDVariable(self, out_name,
                                              VariableType.ARRAY)
            out_names.append(out_name)
        self._ops[node_name] = OpNode(
            name=node_name, op=o.name, inputs=[v.name for v in inputs],
            outputs=out_names, attrs=attrs,
            group=self._active_group)
        self._op_order.append(node_name)
        self._changed()
        outs = [self._vars[n] for n in out_names]
        return outs[0] if n_outputs == 1 else outs

    def remat_scope(self, name: str = "remat"):
        """Context manager: consecutive ops recorded inside run, while
        gradients are being recorded, as one ``torch.utils.checkpoint``
        region: their activations are not kept for the backward but
        recomputed from the region's inputs. Nesting records the
        innermost scope only."""
        @contextlib.contextmanager
        def _scope():
            prev = self._active_group
            self._group_counter += 1
            self._active_group = f"{name}#{self._group_counter}"
            try:
                yield
            finally:
                self._active_group = prev

        return _scope()

    # ------------------------------------------------------------------
    # execution
    def _prune(self, outputs: Sequence[str]) -> List[OpNode]:
        """The ops needed for ``outputs``, in recorded (topo) order."""
        needed_vars, needed_ops = set(outputs), set()
        for op_name in reversed(self._op_order):
            node = self._ops[op_name]
            if any(o in needed_vars for o in node.outputs):
                needed_ops.add(op_name)
                needed_vars.update(node.inputs)
        return [self._ops[n] for n in self._op_order if n in needed_ops]

    @staticmethod
    def _run_nodes(nodes: Sequence[OpNode], env: Env) -> None:
        for node in nodes:
            try:
                args = [env[i] for i in node.inputs]
            except KeyError as e:
                raise KeyError(f"op {node.name!r} needs variable "
                               f"{e.args[0]!r}: missing placeholder?") \
                    from None
            res = registry.get_op(node.op).fn(*args, **node.attrs)
            if isinstance(res, (tuple, list)):
                env.update(zip(node.outputs, res))
            else:
                env[node.outputs[0]] = res

    def _segments(self, outputs: Tuple[str, ...]):
        """The pruned order cut into (group, nodes, inputs from outside,
        outputs used outside) runs: a group is a remat scope's
        consecutive ops, None an op outside any scope."""
        order = self._prune(outputs)
        runs: List[Tuple[Optional[str], List[OpNode]]] = []
        for node in order:
            if runs and node.group is not None and runs[-1][0] == node.group:
                runs[-1][1].append(node)
            else:
                runs.append((node.group, [node]))
        segs = []
        for si, (g, nodes) in enumerate(runs):
            if g is None:
                segs.append((None, nodes, None, None))
                continue
            produced = {o for n in nodes for o in n.outputs}
            ext_in = list(dict.fromkeys(
                i for n in nodes for i in n.inputs if i not in produced))
            later = {i for _, ns in runs[si + 1:] for n in ns
                     for i in n.inputs} | set(outputs)
            ext_out = [o for n in nodes for o in n.outputs if o in later]
            segs.append((g, nodes, ext_in, ext_out))
        return segs

    def _execute(self, outputs: Tuple[str, ...], env: Env) -> Env:
        """Run the ops ``outputs`` need on ``env`` (parameters, constants,
        placeholders by name); remat groups become checkpoint regions
        while autograd records."""
        record = torch.is_grad_enabled()
        for g, nodes, ext_in, ext_out in self._segments(outputs):
            if g is None or not record:
                self._run_nodes(nodes, env)
                continue
            missing = [i for i in ext_in if i not in env]
            if missing:
                raise KeyError(f"remat group {g!r} needs variable "
                               f"{missing[0]!r}: missing placeholder?")
            # the recompute runs in the backward, outside the caller's
            # softmax-dtype scope: carry the scope into the region
            tail = loss_ops.softmax_dtype()

            def seg_fn(*args, _nodes=nodes, _ein=ext_in, _eout=ext_out,
                       _tail=tail):
                local = dict(zip(_ein, args))
                with loss_ops.softmax_dtype_scope(_tail):
                    self._run_nodes(_nodes, local)
                return tuple(local[o] for o in _eout)

            # the port's random ops draw from the device-staged seed and
            # iteration, not from PyTorch's generator, so its state need
            # not be kept (and reading it is not allowed while a CUDA
            # graph is captured); the recompute carries the rng scope
            rng = random_ops.current_rng()

            def seg_rng(*args, _run=seg_fn, _rng=rng):
                if _rng is None:
                    return _run(*args)
                with random_ops.rng_scope(*_rng):
                    return _run(*args)

            res = checkpoint(seg_rng, *[env[i] for i in ext_in],
                             use_reentrant=False, preserve_rng_state=False)
            env.update(zip(ext_out, res))
        missing = [o for o in outputs if o not in env]
        if missing:
            raise KeyError(f"outputs not computable: {missing}")
        return env

    def _prep_placeholders(self, placeholders) -> Env:
        """Placeholders on the device, in their declared dtypes."""
        out = {}
        for k, v in (placeholders or {}).items():
            k = k.name if isinstance(k, SDVariable) else k
            out[k] = self._tensor(v, self._vars[k].dtype
                                  if k in self._vars else None)
        return out

    def _base_env(self, placeholders) -> Env:
        return {**self.constants_map(), **self.trainable_params(),
                **self.state_vars_map(),
                **self._prep_placeholders(placeholders)}

    def output(self, placeholders=None,
               outputs: Optional[Sequence[Union[str, SDVariable]]] = None
               ) -> Dict[str, torch.Tensor]:
        """The values of ``outputs`` (default: the graph's outputs)."""
        names = tuple(o.name if isinstance(o, SDVariable) else o
                      for o in (outputs or self.outputs()))
        with torch.no_grad(), self._call_rng(bool(self._n_random)):
            env = self._execute(names, self._base_env(placeholders))
        return {n: env[n] for n in names}

    def infer_shape(self, name: str) -> Optional[Tuple[int, ...]]:
        """A variable's shape, from its stored value, its declaration, or
        a run of the pruned graph on the ``meta`` device (no data, no
        kernel). None when a placeholder's shape is unknown."""
        v = self._vars[name]
        if name in self._arrays:
            return tuple(self._arrays[name].shape)
        if v.var_type == VariableType.PLACEHOLDER:
            return v._shape
        env = {n: a.to("meta") for n, a in self._arrays.items()}
        for pn in self.placeholders():
            shape = self._vars[pn]._shape
            if shape is None or -1 in shape:
                return None
            env[pn] = torch.empty(shape, dtype=torch_dtype(
                self._vars[pn].dtype), device="meta")
        with torch.no_grad():
            return tuple(self._execute((name,), env)[name].shape)

    # ------------------------------------------------------------------
    # gradients
    def _resolve_loss(self, loss=None) -> Tuple[str, ...]:
        if loss is not None:
            return (loss.name if isinstance(loss, SDVariable) else loss,)
        if self.loss_variables:
            return tuple(self.loss_variables)
        outs = self.outputs()
        if len(outs) == 1:
            return (outs[0],)
        raise ValueError("no loss variable set; call set_loss_variables()")

    def calculate_gradients(self, placeholders=None, wrt=None, loss=None
                            ) -> Dict[str, torch.Tensor]:
        """d(sum of the loss variables)/d(each of ``wrt``, default every
        trainable parameter), through ``torch.autograd``."""
        names = [w.name if isinstance(w, SDVariable) else w
                 for w in (wrt or self.trainable_params().keys())]
        loss_names = self._resolve_loss(loss)
        env = self._base_env(placeholders)
        leaves = {n: env[n].detach().requires_grad_(True) for n in names}
        env.update(leaves)
        with torch.enable_grad(), self._call_rng(bool(self._n_random)):
            outs = self._execute(loss_names, env)
            total = sum(outs[ln].sum() for ln in loss_names)
        grads = torch.autograd.grad(total, list(leaves.values()),
                                    allow_unused=True,
                                    materialize_grads=True)
        return dict(zip(names, grads))

    # ------------------------------------------------------------------
    # training (reference: SameDiff.fit)
    def _grad_step(self, names: List[str],
                   ph: Env) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """The gradient half of the train step (JAX ``grad_fn``): the
        forward under the mixed-precision policy, the backward into the
        float32 masters ``names``. Returns the (unscaled) loss and the
        gradients, on the device; the state variables, fed detached, take
        their declared new values in place after the backward. No host
        sync: fit windows capture it; ``autodiff/step.py`` runs the apply
        half."""
        tc = self.training_config
        mp = tc.mixed_precision
        loss_names = self._resolve_loss()
        updates = dict(self._state_updates)
        masters = self._masters(names)
        leaves = [m.detach().requires_grad_(True) for m in masters]
        env = {**self.constants_map(), **dict(zip(names, leaves)), **ph}
        if mp is not None:
            cdt = mp.dtype
            env = {k: t.to(cdt) if t.is_floating_point() else t
                   for k, t in env.items()}
            tail = mp.softmax_dtype
        else:
            tail = None
        # the state variables stay in their dtype (JAX ``grad_fn``)
        svars = self.state_vars_map()
        env.update({n: t.detach() for n, t in svars.items()})
        with torch.enable_grad(), loss_ops.softmax_dtype_scope(tail):
            outs = self._execute(loss_names + tuple(updates.values()), env)
            loss = sum(outs[ln].sum().float() for ln in loss_names)
        scale = mp.loss_scale if mp is not None else None
        grads = torch.autograd.grad(loss * scale if scale else loss, leaves,
                                    allow_unused=True,
                                    materialize_grads=True)
        if scale:
            grads = [g / scale for g in grads]
        with torch.no_grad():
            for sn, src in updates.items():
                svars[sn].copy_(outs[src])
        return loss.detach(), list(grads)

    def _masters(self, names: List[str]) -> List[torch.Tensor]:
        """The stored trainables ``names``, which the updater changes in
        place."""
        return [self._arrays[n] for n in names]

    def _fit_state(self):
        """(trainable names, updater state per name), the state made or
        kept as the JAX fit keeps it: reused while the trainable set is
        the same."""
        tc = self.training_config
        names = list(self.trainable_params())
        if self._updater_state is None or \
                set(self._updater_state) != set(names):
            masters = [self._arrays[n] for n in names]
            self._updater_state = dict(zip(names, tc.updater.init(masters)))
            self._changed()
        return names, [self._updater_state[n] for n in names]

    def warmup_restore_set(self, names: List[str],
                           state) -> List[torch.Tensor]:
        """What a train step writes in place: the trainables ``names``,
        their updater ``state`` and the state variables."""
        return [self._arrays[n] for n in names] + \
            [t for s in state for t in s] + list(self.state_vars_map().values())

    def _placeholder_dtype(self, name: str, value) -> torch.dtype:
        """The dtype :meth:`_prep_placeholders` gives ``value``."""
        if name in self._vars:
            return torch_dtype(self._vars[name].dtype)
        if isinstance(value, torch.Tensor):
            return value.dtype
        return torch.from_numpy(np.asarray(value)[:0]).dtype

    def _refuse_random_ops(self) -> None:
        window.refuse_random_ops(self)

    def fit(self, dataset_iterator, epochs: int = 1,
            listeners=()) -> History:
        """Train ``epochs`` times over ``dataset_iterator`` (batches of
        ``(features, labels)`` or ``DataSet``s, e.g. a
        ``DeviceCachedIterator``). Features and labels feed the
        placeholders named by the config's ``data_set_feature_mapping`` /
        ``data_set_label_mapping``. The tier (``autodiff/window.py``):
        the scanned epoch with no listeners, ``fused_steps <= 1`` and an
        iterator with ``stacked_batches``; fused windows of
        ``fused_steps`` steps when it is above 1; else one step a batch.
        ``listeners`` get each step's loss in bursts
        (``Listener.iterations_done``). The config's ``accum_steps`` > 1
        accumulates gradients over that many steps (fused windows);
        ``sentinel`` raises ``TrainingDivergedError`` at the first step
        whose loss or gradients went non-finite."""
        tc = self.training_config
        if tc is None:
            raise ValueError("set sd.training_config = TrainingConfig(...) "
                             "first")
        return window.fit(self, dataset_iterator, epochs, listeners)
