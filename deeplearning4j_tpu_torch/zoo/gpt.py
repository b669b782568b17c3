"""GPT-style autoregressive decoder built on SameDiff.

Counterpart of ``deeplearning4j_tpu/zoo/gpt.py`` (``GPTConfig`` :29,
``GPT_MEDIUM``, ``GPT_TINY``, ``build_gpt`` :71, ``gpt_param_names``
:159, and the decode-mode hook of the serving tier: ``gpt_decode_fns``
:180 and ``gpt_paged_decode_fns`` :472 with their speculative verifiers
(:406, :701), ``_quantized_param_names`` :764, ``gpt_quantize_params``
:776, ``gpt_kv_scales`` :801, ``gpt_paged_spec`` :869,
``gpt_generative_spec`` :904). The same variable names, the same numpy
``default_rng(seed)`` draws in the same order and the same per-head
``[q_a|k_a|v_a]`` layout of the fused qkv projection, so a seed gives the
JAX package's weights; kernels are ``[n_in, n_out]`` there and here.

Pre-LN residual blocks; the MLP's activation is the ``gelu`` op with its
default attribute, i.e. the tanh approximation (the JAX module's
docstring says erf-gelu; its code records tanh-gelu, and the port follows
the code); learned positions; one ``scaled_dot_product_attention`` op per
layer (the CUDA kernels of ``kernels/attention.py`` on the card); each
block in its own ``remat_scope``; a weight-tied head and sparse softmax
cross-entropy on integer targets.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from deeplearning4j_tpu_torch.environment import DeviceLike


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 32768
    hidden_size: int = 2048
    num_layers: int = 12
    num_heads: int = 16
    intermediate_size: int = 8192
    max_seq_len: int = 1024
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-5
    remat: bool = True          # one checkpoint region per block
    tie_embeddings: bool = True

    @property
    def head_size(self) -> int:
        return self.hidden_size // self.num_heads


# ~505M parameters: the JAX package's compute-dense flagship (bench.py
# bench_gpt_medium)
GPT_MEDIUM = GPTConfig(hidden_size=1536, num_layers=16,
                       intermediate_size=6144, num_heads=12)
GPT_TINY = GPTConfig(vocab_size=256, hidden_size=64, num_layers=2,
                     num_heads=4, intermediate_size=128, max_seq_len=64)


def _layer_norm(sd, scope, x, width, eps):
    g = sd.var(f"{scope}/gamma", value=np.ones(width, np.float32))
    b = sd.var(f"{scope}/beta", value=np.zeros(width, np.float32))
    return sd.invoke("layer_norm", [x, g, b], {"epsilon": eps},
                     name=f"{scope}/ln")


def _dense(sd, rng, scope, x, n_in, n_out, std):
    w = sd.var(f"{scope}/kernel",
               value=(rng.standard_normal((n_in, n_out)) * std)
               .astype(np.float32))
    b = sd.var(f"{scope}/bias", value=np.zeros(n_out, np.float32))
    h = sd.invoke("matmul", [x, w], name=f"{scope}/matmul")
    return sd.invoke("bias_add", [h, b], name=f"{scope}/bias")


def build_gpt(cfg: GPTConfig, batch: int, seq_len: int, seed: int = 0,
              device: DeviceLike = None):
    """The decoder LM as a SameDiff graph on ``device`` (the CUDA card
    unless ``device="cpu"``).

    Placeholders: ``input_ids`` [batch, seq] int32, ``targets`` [batch,
    seq] int32 (next-token ids). Outputs: ``logits`` [batch, seq, vocab]
    and the scalar ``loss`` (the loss variable)."""
    from deeplearning4j_tpu_torch.autodiff import SameDiff

    if seq_len > cfg.max_seq_len:
        raise ValueError(f"seq_len {seq_len} > max_seq_len "
                         f"{cfg.max_seq_len}")
    H, A, D = cfg.hidden_size, cfg.num_heads, cfg.head_size
    rng = np.random.default_rng(seed)
    std = cfg.initializer_range
    # GPT-2 scales residual-out projections by 1/sqrt(2L)
    res_std = std / np.sqrt(2.0 * cfg.num_layers)

    sd = SameDiff(device=device)
    ids = sd.placeholder("input_ids", shape=(batch, seq_len), dtype="int32")
    targets = sd.placeholder("targets", shape=(batch, seq_len),
                             dtype="int32")

    wte = sd.var("wte", value=(rng.standard_normal((cfg.vocab_size, H))
                               * std).astype(np.float32))
    wpe = sd.var("wpe", value=(rng.standard_normal((cfg.max_seq_len, H))
                               * std).astype(np.float32))
    x = sd.invoke("embedding_lookup", [wte, ids], name="tok_emb")
    pos = sd.invoke("slice", [wpe], {"begin": (0, 0), "size": (seq_len, H)},
                    name="pos_slice")
    x = x.add(pos, name="emb")

    for i in range(cfg.num_layers):
        sc = f"h{i}"
        ctx = sd.remat_scope(sc) if cfg.remat else contextlib.nullcontext()
        with ctx:
            y = _layer_norm(sd, f"{sc}/ln_1", x, H, cfg.layer_norm_eps)
            qkv = _dense(sd, rng, f"{sc}/attn/qkv", y, H, 3 * H, std)
            # per-head blocks [q_a|k_a|v_a], as the JAX package lays them out
            qkv = sd.invoke("reshape", [qkv],
                            {"shape": (batch, seq_len, A, 3 * D)},
                            name=f"{sc}/attn/split_heads")
            qkv = sd.invoke("permute", [qkv], {"axes": (0, 2, 1, 3)},
                            name=f"{sc}/attn/heads_t")   # [B, A, S, 3D]
            q, k, v = sd.invoke("split", [qkv],
                                {"num_split": 3, "axis": 3},
                                name=f"{sc}/attn/qkv_split", n_outputs=3)
            att = sd.invoke("scaled_dot_product_attention", [q, k, v],
                            {"causal": True}, name=f"{sc}/attn/sdpa")
            att = sd.invoke("permute", [att], {"axes": (0, 2, 1, 3)},
                            name=f"{sc}/attn/merge_t")
            att = sd.invoke("reshape", [att],
                            {"shape": (batch, seq_len, H)},
                            name=f"{sc}/attn/merge")
            att = _dense(sd, rng, f"{sc}/attn/proj", att, H, H, res_std)
            x = x.add(att, name=f"{sc}/res_1")
            y = _layer_norm(sd, f"{sc}/ln_2", x, H, cfg.layer_norm_eps)
            y = _dense(sd, rng, f"{sc}/mlp/fc", y, H, cfg.intermediate_size,
                       std)
            y = sd.invoke("gelu", [y], name=f"{sc}/mlp/act")
            y = _dense(sd, rng, f"{sc}/mlp/proj", y, cfg.intermediate_size,
                       H, res_std)
            x = x.add(y, name=f"{sc}/res_2")

    x = _layer_norm(sd, "ln_f", x, H, cfg.layer_norm_eps)
    if cfg.tie_embeddings:
        logits = sd.invoke("einsum", [x, wte],
                           {"equation": "bsh,vh->bsv"}, name="logits")
    else:
        head = sd.var("lm_head", value=(rng.standard_normal(
            (H, cfg.vocab_size)) * std).astype(np.float32))
        logits = sd.invoke("matmul", [x, head], name="logits")
    loss = sd.invoke("sparse_softmax_cross_entropy", [logits, targets],
                     name="loss")
    sd.set_loss_variables([loss])
    return sd


def gpt_param_names(cfg: GPTConfig):
    """The trained-variable names :func:`build_gpt` creates."""
    names = ["wte", "wpe", "ln_f/gamma", "ln_f/beta"]
    for i in range(cfg.num_layers):
        for part in ("ln_1/gamma", "ln_1/beta",
                     "attn/qkv/kernel", "attn/qkv/bias",
                     "attn/proj/kernel", "attn/proj/bias",
                     "ln_2/gamma", "ln_2/beta",
                     "mlp/fc/kernel", "mlp/fc/bias",
                     "mlp/proj/kernel", "mlp/proj/bias"):
            names.append(f"h{i}/{part}")
    if not cfg.tie_embeddings:
        names.append("lm_head")
    return names



# ----------------------------------------------------------------------
# decode mode: the serving tier's prefill, decode and verify steps
def _quantized_param_names(cfg: GPTConfig):
    """The matmul weights and the embedding that carry int8 payloads under
    ``quantize_weights`` (JAX ``zoo/gpt.py:764``): the big operands whose
    bytes a decode step reads. Layer norms and biases stay float32."""
    names = [n for n in gpt_param_names(cfg) if n.endswith("/kernel")]
    names.append("wte")
    if not cfg.tie_embeddings:
        names.append("lm_head")
    return names


def gpt_quantize_params(raw: dict, cfg: GPTConfig) -> dict:
    """Symmetric per-output-channel int8 of the decode parameters (JAX
    ``zoo/gpt.py:776``): every ``/kernel`` and the embedding become an int8
    payload with a float32 ``<name>::scale`` (absmax scales over the last
    axis, ``evaluation.calibration.absmax_scales``); ``wte``'s channels are
    its HIDDEN axis, so one scale serves the embedding take and the tied
    logits. Computed where the tensors lie (the card, for a served model):
    payloads and scales equal the JAX function's bit for bit (the quotient
    in float32, ``round`` half to even, the clip). Pure: a pull after
    ``fit()`` re-quantizes the new weights."""
    from deeplearning4j_tpu_torch.evaluation.calibration import (
        absmax_scales, quantize_symmetric)
    out = {}
    qnames = set(_quantized_param_names(cfg))
    with torch.no_grad():
        for n, a in raw.items():
            if n in qnames:
                w = torch.as_tensor(a).to(torch.float32)
                s = absmax_scales(w)                           # [n_out]
                out[n] = quantize_symmetric(w, s)
                out[n + "::scale"] = s
            else:
                out[n] = a
    return out


class _DecodeMath:
    """The per-token math of :func:`build_gpt` over a name -> tensor
    parameter dict, as the JAX decode functions write it: the one-pass
    layer norm (the port's ``layer_norm`` op), tanh-gelu, the per-head
    ``[q|k|v]`` blocks and the tied logits. With ``quantize_weights`` the
    parameters are :func:`gpt_quantize_params`'s: every projection and the
    tied logits are one ``int8_matmul`` launch (the JAX ``_matmul`` and
    ``_logits`` :262-293), and the embedding take dequantises the gathered
    ``wte`` rows (``_tok_emb`` :277-281, a gather, not a product). With
    ``kv_scales`` (:func:`gpt_kv_scales`' ``{"k", "v"}`` [L, A, D]) the
    slabs are int8, written through ``paged_attention.q_store`` and read
    through ``q_load``, the JAX ``_q_store`` and ``_q_load`` (:294-304)."""

    def __init__(self, cfg: GPTConfig, quantize_weights: bool = False,
                 kv_scales=None):
        from deeplearning4j_tpu_torch.kernels.int8_matmul import int8_matmul
        from deeplearning4j_tpu_torch.ops.elementwise import gelu
        from deeplearning4j_tpu_torch.ops.nn_ops import layer_norm
        self.cfg = cfg
        self.qw = bool(quantize_weights)
        self._layer_norm, self._gelu = layer_norm, gelu
        self._int8_matmul = int8_matmul
        self._kv_host = None if kv_scales is None else tuple(
            torch.from_numpy(np.ascontiguousarray(kv_scales[n], np.float32))
            for n in ("k", "v"))
        self._kv_on = {}                # device -> the scales there

    def kv(self, dev, i):
        """Layer ``i``'s (k_scale, v_scale) [A, D] float32 on ``dev``, or
        (None, None) for float slabs."""
        if self._kv_host is None:
            return None, None
        if dev not in self._kv_on:
            self._kv_on[dev] = tuple(t.to(dev) for t in self._kv_host)
        ks, vs = self._kv_on[dev]
        return ks[i], vs[i]

    def ln(self, p, sc, x):
        return self._layer_norm(x, p[f"{sc}/gamma"], p[f"{sc}/beta"],
                                epsilon=self.cfg.layer_norm_eps)

    def mm(self, p, name, x):
        """``x @ p[name]``; int8: ``int8_matmul`` with the channel scale
        applied to the product."""
        if self.qw:
            return self._int8_matmul(x, p[name], p[name + "::scale"])
        return x @ p[name]

    def emb(self, p, tokens):
        """The token embeddings ``wte[tokens]``; int8: the gathered rows
        times the hidden channels' scale."""
        e = p["wte"][tokens]
        if self.qw:
            e = e.to(torch.float32) * p["wte::scale"]
        return e

    def qkv(self, p, i, x):
        """[rows, A, D] views of q, k and v of layer ``i`` (per-head
        blocks of the fused projection)."""
        cfg = self.cfg
        y = self.ln(p, f"h{i}/ln_1", x)
        qkv = self.mm(p, f"h{i}/attn/qkv/kernel", y) \
            + p[f"h{i}/attn/qkv/bias"]
        qkv = qkv.view(x.shape[0], cfg.num_heads, 3 * cfg.head_size)
        return qkv.split(cfg.head_size, dim=-1)

    def rest(self, p, i, x, att):
        """The block after attention: projection, residual, MLP,
        residual."""
        att = att.reshape(x.shape[0], self.cfg.hidden_size)
        x = x + (self.mm(p, f"h{i}/attn/proj/kernel", att)
                 + p[f"h{i}/attn/proj/bias"])
        y = self.ln(p, f"h{i}/ln_2", x)
        y = self.mm(p, f"h{i}/mlp/fc/kernel", y) + p[f"h{i}/mlp/fc/bias"]
        y = self._gelu(y)
        return x + (self.mm(p, f"h{i}/mlp/proj/kernel", y)
                    + p[f"h{i}/mlp/proj/bias"])

    def logits(self, p, x):
        x = self.ln(p, "ln_f", x)
        if self.cfg.tie_embeddings:
            if self.qw:
                # (wte_i8 * s_h) contracted over h is wte_i8 contracted
                # with (x * s_h): the scale folds into the activation
                return self._int8_matmul(x, p["wte"], p["wte::scale"],
                                         transposed=True)
            return x @ p["wte"].t()
        return self.mm(p, "lm_head", x)


def _to_device(arrays, dev):
    """Host int arrays -> int32 tensors on ``dev`` in one copy."""
    flat = [np.asarray(a, np.int32).reshape(-1) for a in arrays]
    buf = torch.from_numpy(np.concatenate(flat)).to(dev)
    out, o = [], 0
    for a, f in zip(arrays, flat):
        out.append(buf[o:o + f.size].view(np.shape(a)))
        o += f.size
    return out


def gpt_decode_fns(cfg: GPTConfig, quantize_weights: bool = False,
                   kv_scales=None):
    """``(prefill_fn, decode_fn, verify_fn)`` over DENSE per-slot KV slabs,
    the counterpart of the JAX ``gpt_decode_fns`` (:180). KV slab layout
    (one tensor each for K and V)::

        [num_layers, max_slots, heads, max_seq, head_dim]

    The slabs are allocated once by the server and updated in place (the
    counterpart of the JAX donation); each function returns them with
    ``(next_token, logits)`` on the slabs' device.

    - ``prefill_fn(params, kc, vc, io)``, ``io = {"tokens": [Lb],
      "length": (), "slot": ()}``: the causal forward over the
      bucket-padded prompt, its attention the registered
      ``scaled_dot_product_attention(causal=True)`` over its own fresh q,
      k, v; rows ``0..Lb-1`` of K and V written to slot ``slot``; the
      greedy token and logits at position ``length - 1``.
    - ``decode_fn(params, kc, vc, io)``, ``io = {"tokens": [S],
      "positions": [S], "active": [S] bool}``: every active slot advances
      one token; each layer is one ``paged_decode_attention`` launch over
      the slab (``BS = max_seq``, the table of slot ``s`` is ``[s]``):
      the slot's K/V row written at its position (``write_block = s``,
      ``write_off = position``; an inactive slot keeps its rows), then
      its attention over keys ``<= position`` only.
    - ``verify_fn(params, kc, vc, io)``, ``io = {"tokens": [S, W],
      "positions": [S], "active": [S] bool}`` (JAX :406): the speculative
      verifier. Window row ``w`` of slot ``s`` sits at position
      ``positions[s] + w`` (clipped to ``max_seq - 1``); each layer is one
      ``paged_verify_attention`` launch over the slab: every active
      slot's W K/V rows written (a row clipped onto the slab's last
      position writes nothing; an inactive slot writes nothing), row ``w``
      attending to keys ``<= positions[s] + w``, its window's keys taken
      from the rows the launch writes. Returns ``(kc, vc, out [S, W],
      logits [S, W, V])``, ``out[s, w]`` the greedy token after window
      tokens ``0..w``; row ``w`` equals ``decode_fn`` fed the same prefix.

    ``quantize_weights=True`` takes :func:`gpt_quantize_params`'s
    dictionary: every projection and the tied logits are ``int8_matmul``
    launches. ``kv_scales`` (:func:`gpt_kv_scales`' ``{"k", "v"}`` [L, A,
    D]) makes the slabs int8, as the JAX functions do: every row written
    is stored ``clip(round(x / s), -127, 127)`` and every read
    dequantises; the prefill's attention runs over its fresh float k and
    v (only its slab write is quantised, JAX :335-341), the decode and the
    verify over what the slab holds, their own rows in stored form (the
    kernels' int8 path).
    """
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    from deeplearning4j_tpu_torch.ops.registry import get_op
    sdpa = get_op("scaled_dot_product_attention").fn
    math = _DecodeMath(cfg, quantize_weights, kv_scales)

    def prefill_fn(params, kc, vc, io):
        p, dev = params, kc.device
        lb = int(np.shape(io["tokens"])[0])
        length, slot = int(io["length"]), int(io["slot"])
        (tokens,) = _to_device([io["tokens"]], dev)
        x = math.emb(p, tokens) + p["wpe"][:lb]                 # [Lb, H]
        for i in range(cfg.num_layers):
            q, k, v = (t.transpose(0, 1) for t in math.qkv(p, i, x))
            att = sdpa(q[None], k[None], v[None], causal=True)[0]
            # this slot's prompt rows (positions 0..Lb-1); rows past the
            # real length hold padding K/V, masked until decode writes there
            ks, vs = math.kv(dev, i)
            kc[i, slot, :, :lb] = pa.q_store(
                k, None if ks is None else ks[:, None, :])
            vc[i, slot, :, :lb] = pa.q_store(
                v, None if vs is None else vs[:, None, :])
            x = math.rest(p, i, x, att.transpose(0, 1))
        logits = math.logits(p, x[max(length - 1, 0)][None])[0]
        return kc, vc, logits.argmax().to(torch.int32), logits

    def decode_fn(params, kc, vc, io):
        p, dev = params, kc.device
        active = np.asarray(io["active"], bool)
        S, T = kc.shape[1], kc.shape[3]
        pos = np.clip(np.asarray(io["positions"]), 0, T - 1)
        # an inactive lane writes nothing and attends to its key 0 only:
        # its output is unused
        tokens, pos_d, kmax, wb, tables = _to_device(
            [io["tokens"], pos, np.where(active, pos, 0),
             np.where(active, np.arange(S), -1), np.arange(S)[:, None]], dev)
        lanes = tables[:, 0]
        x = math.emb(p, tokens) + p["wpe"][pos_d]               # [S, H]
        for i in range(cfg.num_layers):
            q, k, v = math.qkv(p, i, x)
            att = pa.paged_decode_attention(q, k, v, kc[i], vc[i], tables,
                                            lanes, kmax, wb, pos_d,
                                            *math.kv(dev, i))
            x = math.rest(p, i, x, att)
        logits = math.logits(p, x)                              # [S, V]
        return kc, vc, logits.argmax(-1).to(torch.int32), logits

    def verify_fn(params, kc, vc, io):
        S, T = kc.shape[1], kc.shape[3]
        tokens = np.asarray(io["tokens"])
        W = tokens.shape[1]
        active = np.asarray(io["active"], bool)
        pos0 = np.asarray(io["positions"]).astype(np.int64)
        at = pos0[:, None] + np.arange(W)[None, :]              # [S, W]
        pos = np.clip(at, 0, T - 1)
        wb = np.where(active[:, None] & (at <= T - 1),
                      np.arange(S)[:, None], -1)
        return _verify(math, params, kc, vc, tokens, pos, active,
                       np.clip(pos0, 0, T - 1), np.arange(S)[:, None], wb,
                       pos)

    return prefill_fn, decode_fn, verify_fn


def _verify(math, p, kc, vc, tokens, pos, active, pos0, tables, wb, wo):
    """The verify of both decode-function families: the ``[S, W]`` window
    as ``S W`` rows (row ``s W + w``), one ``paged_verify_attention``
    launch a layer. ``pos`` [S, W] the rows' positions, ``pos0`` [S] each
    lane's first window position, ``tables`` [S, MAXB], ``wb``/``wo`` [S,
    W] the write places (-1: none). An inactive lane writes nothing and
    attends to its key 0 only (its output is unused)."""
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    S, W = tokens.shape
    lanes = np.repeat(np.arange(S), W)
    act = np.repeat(active, W)
    tok, pos_d, lane, kmax, win0, wrow, tab, wb_d, wo_d = _to_device(
        [tokens.reshape(-1), pos.reshape(-1), lanes,
         np.where(act, pos.reshape(-1), 0), np.where(act, pos0[lanes], -1),
         lanes * W, tables, np.where(active[:, None], wb, -1).reshape(-1),
         np.where(wb >= 0, wo, 0).reshape(-1)], kc.device)
    x = math.emb(p, tok) + p["wpe"][pos_d]                      # [S W, H]
    for i in range(math.cfg.num_layers):
        q, k, v = math.qkv(p, i, x)
        att = pa.paged_verify_attention(q, k, v, kc[i], vc[i], tab, lane,
                                        kmax, win0, wrow, wb_d, wo_d,
                                        *math.kv(kc.device, i))
        x = math.rest(p, i, x, att)
    logits = math.logits(p, x).view(S, W, -1)                  # [S, W, V]
    return kc, vc, logits.argmax(-1).to(torch.int32), logits


def gpt_paged_decode_fns(cfg: GPTConfig, block_size: int,
                         max_blocks_per_req: int,
                         quantize_weights: bool = False, kv_scales=None):
    """``(prefill_fn, decode_fn, verify_fn)`` over PAGED KV slabs, the
    counterpart of the JAX ``gpt_paged_decode_fns`` (:472). KV slab layout
    (one tensor each for K and V)::

        [num_layers, num_blocks, heads, block_size, head_dim]

    Block 0 is the null block, never handed out. Each layer's attention
    reads each row's keys through its table up to its last key, so unused
    table entries (the null block) and the stale rows of a block are never
    read: one ``paged_decode_attention`` launch a layer of a decode step
    (the step's K/V write and the attention), one
    ``paged_prefill_attention`` call a layer of a prefill.

    - ``prefill_fn(params, kc, vc, io)``, ``io = {"tokens": [Lb] (the
      bucket-padded prompt suffix after a prefix-cache hit), "length": ()
      (its real length), "hist": () (cached prefix length, a multiple of
      block_size), "table": [MAXB]}``: the suffix's real rows' K/V are
      written into their blocks FIRST, then every row attends over the
      whole table up to its own position (suffix row ``j``'s last key is
      ``hist + j``; a padded row ``j >= length`` attends as the last real
      row does, its output unused, and its K/V are not written); the
      greedy token and logits at global position ``hist + length - 1``.
    - ``decode_fn(params, kc, vc, io)``, ``io = {"tokens": [S],
      "positions": [S], "active": [S] bool, "tables": [S, MAXB],
      "write_block": [S], "write_off": [S]}``: each active lane's new K/V
      row lands at ``(write_block, write_off)`` (where its position lies
      through its table, as ``paged_decode_attention`` requires), then it
      attends over its table to its position.
    - ``verify_fn(params, kc, vc, io)``, ``io = {"tokens": [S, W],
      "positions": [S], "active": [S] bool, "tables": [S, MAXB],
      "write_block": [S, W], "write_off": [S, W]}`` (JAX :701): the
      speculative verifier over the block tables, window row ``w`` at
      position ``positions[s] + w`` (clipped to ``max_seq_len - 1``),
      writing at ``(write_block, write_off)`` (-1: no write; an inactive
      lane writes nothing, where the JAX package sends its writes to the
      null block), one ``paged_verify_attention`` launch a layer; returns
      as the dense ``verify_fn``.

    ``quantize_weights`` and ``kv_scales`` as :func:`gpt_decode_fns`; with
    ``kv_scales`` the prefill writes the suffix's rows stored (int8) first
    and attends over the table dequantised, its own rows included (JAX
    :612-628), one int8 ``paged_prefill_attention`` call a layer.
    """
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    math = _DecodeMath(cfg, quantize_weights, kv_scales)
    A, BS, MAXB = cfg.num_heads, int(block_size), int(max_blocks_per_req)
    T = MAXB * BS

    def prefill_fn(params, kc, vc, io):
        p, dev = params, kc.device
        table = np.asarray(io["table"])
        lb = int(np.shape(io["tokens"])[0])
        length, hist = int(io["length"]), int(io["hist"])
        j = np.arange(lb)
        g = hist + j
        gpos = np.clip(g, 0, cfg.max_seq_len - 1)
        real = g[:length]
        # suffix row j's last key; a padded row stops at the last real one
        kmax = hist + np.minimum(j, length - 1)
        tokens, gpos_d, kmax_d, blk, off, table_d = _to_device(
            [io["tokens"], gpos, kmax, table[np.clip(real // BS, 0, MAXB - 1)],
             np.clip(real, 0, T - 1) % BS, table], dev)
        x = math.emb(p, tokens) + p["wpe"][gpos_d]              # [Lb, H]
        at = (blk[:, None], torch.arange(A, device=dev)[None, :],
              off[:, None])
        for i in range(cfg.num_layers):
            q, k, v = math.qkv(p, i, x)
            ks, vs = math.kv(dev, i)
            # write the suffix K/V first: its rows attend to themselves
            kc[i].index_put_(at, pa.q_store(k[:length], ks))
            vc[i].index_put_(at, pa.q_store(v[:length], vs))
            att = pa.paged_prefill_attention(q, kc[i], vc[i], table_d,
                                             kmax_d, kmax, ks, vs)
            x = math.rest(p, i, x, att)
        logits = math.logits(p, x[max(length - 1, 0)][None])[0]
        return kc, vc, logits.argmax().to(torch.int32), logits

    def decode_fn(params, kc, vc, io):
        p, dev = params, kc.device
        active = np.asarray(io["active"], bool)
        S = active.shape[0]
        pos = np.clip(np.asarray(io["positions"]), 0, cfg.max_seq_len - 1)
        # an inactive lane writes nothing and attends to its key 0 only:
        # its output is unused
        tokens, pos_d, kmax, tables, wb, wo, lanes = _to_device(
            [io["tokens"], pos, np.where(active, pos, 0), io["tables"],
             np.where(active, io["write_block"], -1),
             np.where(active, io["write_off"], 0), np.arange(S)], dev)
        x = math.emb(p, tokens) + p["wpe"][pos_d]               # [S, H]
        for i in range(cfg.num_layers):
            q, k, v = math.qkv(p, i, x)
            att = pa.paged_decode_attention(q, k, v, kc[i], vc[i], tables,
                                            lanes, kmax, wb, wo,
                                            *math.kv(dev, i))
            x = math.rest(p, i, x, att)
        logits = math.logits(p, x)                              # [S, V]
        return kc, vc, logits.argmax(-1).to(torch.int32), logits

    def verify_fn(params, kc, vc, io):
        tokens = np.asarray(io["tokens"])
        W = tokens.shape[1]
        pos0 = np.asarray(io["positions"]).astype(np.int64)
        pos = np.clip(pos0[:, None] + np.arange(W)[None, :], 0,
                      cfg.max_seq_len - 1)                      # [S, W]
        return _verify(math, params, kc, vc, tokens, pos,
                       np.asarray(io["active"], bool),
                       np.clip(pos0, 0, cfg.max_seq_len - 1), io["tables"],
                       np.asarray(io["write_block"]),
                       np.asarray(io["write_off"]))

    return prefill_fn, decode_fn, verify_fn


def gpt_kv_scales(sd, cfg: GPTConfig, prompts=None,
                  method: str = "quantile", quantile: float = 0.9995):
    """Per-(layer, head, channel) int8 scales for the KV cache, the JAX
    ``gpt_kv_scales`` (:801): the full-precision dense prefill of
    :func:`gpt_decode_fns` over each calibration prompt on one-slot slabs
    of its length, on the graph's device, then the rows it wrote through
    :func:`~deeplearning4j_tpu_torch.evaluation.calibration.channel_scales`
    on the host (quantile clipping by default: K/V have outlier tails that
    absmax would let starve the int8 grid). Returns ``{"k": [L, A, D],
    "v": [L, A, D]}`` float32 numpy, the ``kv_scales`` of the decode
    functions. ``prompts=None`` makes JAX's set: 4 prompts of ``min(32,
    max_seq_len - 1)`` tokens from ``default_rng(0)``."""
    from deeplearning4j_tpu_torch.evaluation.calibration import channel_scales
    names = _check_decode_params(sd, cfg)
    params = {n: sd.get_arr_for_var(n) for n in names}
    dev = params["wte"].device
    prefill_fn, _, _ = gpt_decode_fns(cfg)
    if prompts is None:
        rng = np.random.default_rng(0)
        span = min(32, cfg.max_seq_len - 1)
        prompts = [rng.integers(0, cfg.vocab_size, size=span)
                   for _ in range(4)]
    k_rows, v_rows = [], []
    with torch.inference_mode():
        for pr in prompts:
            pr = np.asarray(pr, np.int32).reshape(-1)
            lp = int(pr.size)
            shape = (cfg.num_layers, 1, cfg.num_heads, lp, cfg.head_size)
            kc, vc = (torch.zeros(shape, dtype=params["wte"].dtype,
                                  device=dev) for _ in range(2))
            kc, vc, _, _ = prefill_fn(params, kc, vc, {
                "tokens": pr, "length": np.int32(lp), "slot": np.int32(0)})
            k_rows.append(kc[:, 0].cpu().numpy())       # [L, A, Lp, D]
            v_rows.append(vc[:, 0].cpu().numpy())

    def _scales(rows):
        obs = np.concatenate(rows, axis=2)               # [L, A, N, D]
        flat = np.transpose(obs, (2, 0, 1, 3)).reshape(obs.shape[2], -1)
        sc = channel_scales(flat, method=method, quantile=quantile)
        return sc.reshape(cfg.num_layers, cfg.num_heads, cfg.head_size)

    return {"k": _scales(k_rows), "v": _scales(v_rows)}


def _check_decode_params(sd, cfg: GPTConfig):
    names = gpt_param_names(cfg)
    missing = [n for n in names if not sd.has_variable(n)]
    if missing:
        raise ValueError(
            f"graph is missing decode parameters {missing[:4]}"
            f"{'...' if len(missing) > 4 else ''}: was it built by "
            f"zoo.gpt.build_gpt with this config?")
    return names


def _params_pull(sd, cfg: GPTConfig, names, quantize_weights: bool):
    """The parameters by name, as the SameDiff holds them now (tensors on
    its device; ``fit`` updates them in place, ``set_arr_for_var``
    rebinds a name, which the next pull sees); with ``quantize_weights``
    re-quantized at every pull (:func:`gpt_quantize_params`), so that
    ``update_model()`` after ``fit()`` serves the new weights."""
    if quantize_weights:
        return lambda: gpt_quantize_params(
            {n: sd.get_arr_for_var(n) for n in names}, cfg)
    return lambda: {n: sd.get_arr_for_var(n) for n in names}


def _kv_dtype(sd, quantize_kv: bool) -> str:
    """The slabs hold int8 under ``quantize_kv``, else the weights' dtype:
    float32, as the JAX serving path (float64 when the weights are
    float64)."""
    if quantize_kv:
        return "int8"
    return str(sd.get_arr_for_var("wte").dtype).replace("torch.", "")


def gpt_paged_spec(sd, cfg: GPTConfig, quantize_weights: bool = False,
                   quantize_kv: bool = False, calibration_prompts=None):
    """The PAGED decode-mode hook: a
    :class:`~deeplearning4j_tpu_torch.serving.paged.PagedGenerativeSpec`
    over a :func:`build_gpt` graph, what ``PagedGenerativeServer``
    serves. The decode functions are built per (block_size,
    max_blocks_per_req) geometry by the server; their ``verify_fn`` makes
    the spec a speculative target. ``quantize_weights`` serves int8
    weight payloads (:func:`gpt_quantize_params`, re-quantized at every
    pull); ``quantize_kv`` makes the block pool int8 (``kv_dtype``
    ``"int8"``, so a pool sized in bytes holds 4x the float32 blocks), with
    scales from :func:`gpt_kv_scales` over ``calibration_prompts``,
    calibrated once, here."""
    from deeplearning4j_tpu_torch.serving.paged import PagedGenerativeSpec
    names = _check_decode_params(sd, cfg)
    kv_scales = gpt_kv_scales(sd, cfg, prompts=calibration_prompts) \
        if quantize_kv else None
    return PagedGenerativeSpec(
        params=_params_pull(sd, cfg, names, quantize_weights),
        make_fns=lambda block_size, max_blocks: gpt_paged_decode_fns(
            cfg, block_size, max_blocks, quantize_weights=quantize_weights,
            kv_scales=kv_scales),
        kv_shape=lambda num_blocks, block_size: (
            cfg.num_layers, int(num_blocks), cfg.num_heads,
            int(block_size), cfg.head_size),
        vocab_size=cfg.vocab_size,
        max_seq_len=cfg.max_seq_len,
        num_heads=cfg.num_heads,
        kv_dtype=_kv_dtype(sd, quantize_kv))


def gpt_generative_spec(sd, cfg: GPTConfig, quantize_weights: bool = False,
                        quantize_kv: bool = False,
                        calibration_prompts=None):
    """The dense decode-mode hook: a
    :class:`~deeplearning4j_tpu_torch.serving.generative.GenerativeSpec`
    over a :func:`build_gpt` graph, what ``GenerativeServer`` serves.
    Parameters are pulled from the SameDiff by name, so
    ``server.update_model()`` serves what the graph holds then. The spec
    carries the verify function, so a server over it can be a speculative
    target, and a second spec passed as ``draft_spec=`` its draft.
    ``quantize_weights`` serves int8 weight payloads (re-quantized at
    every pull); ``quantize_kv`` makes the slabs int8 with scales from
    :func:`gpt_kv_scales` over ``calibration_prompts``, as
    :func:`gpt_paged_spec`."""
    from deeplearning4j_tpu_torch.serving.generative import GenerativeSpec
    names = _check_decode_params(sd, cfg)
    kv_scales = gpt_kv_scales(sd, cfg, prompts=calibration_prompts) \
        if quantize_kv else None
    pull = _params_pull(sd, cfg, names, quantize_weights)
    prefill_fn, decode_fn, verify_fn = gpt_decode_fns(
        cfg, quantize_weights=quantize_weights, kv_scales=kv_scales)
    return GenerativeSpec(
        params=pull,
        prefill=prefill_fn,
        decode=decode_fn,
        kv_shape=lambda max_slots, max_seq: (
            cfg.num_layers, int(max_slots), cfg.num_heads, int(max_seq),
            cfg.head_size),
        vocab_size=cfg.vocab_size,
        max_seq_len=cfg.max_seq_len,
        kv_dtype=_kv_dtype(sd, quantize_kv),
        verify=verify_fn)
