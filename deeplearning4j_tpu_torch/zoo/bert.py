"""BERT as a frozen TF GraphDef and its import path (BASELINE config 4).

A copy of ``deeplearning4j_tpu/zoo/bert.py``: ``BertConfig``, ``BERT_BASE``,
``BERT_TINY``, ``_BertGraphBuilder`` and ``build_bert_graphdef`` write the
same bytes for the same arguments; ``bert_base`` imports them with the
port's importer (``modelimport/tf_import.py``) onto ``device``, the CUDA
card unless ``device="cpu"``.

The reference's BERT benchmark imports a frozen google-research/bert .pb
through samediff-import-tensorflow (ImportGraph.kt:218). No TensorFlow is
needed here: ``build_bert_graphdef`` writes the node and op patterns of a
frozen BERT inference graph (GatherV2 embeddings, a StridedSlice of the
position table, the Mean/SquaredDifference/Rsqrt layer norm, erf gelu,
per-head Reshape/Transpose with BatchMatMulV2 attention, the
``(1 - mask) * -10000`` additive attention bias) through the protobuf wire
encoder (``modelimport/tf_builder.py``), so the import path is that of a
file TF wrote: bytes, GraphDef decode, op-by-op mapping, SameDiff.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from deeplearning4j_tpu_torch.environment import DeviceLike
from deeplearning4j_tpu_torch.modelimport.tf_builder import GraphDefBuilder


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12

    @property
    def head_size(self) -> int:
        return self.hidden_size // self.num_heads


BERT_BASE = BertConfig()
BERT_TINY = BertConfig(vocab_size=128, hidden_size=32, num_layers=2,
                       num_heads=2, intermediate_size=64,
                       max_position_embeddings=64, type_vocab_size=2)


class _BertGraphBuilder:
    """Emits frozen-BERT GraphDef nodes (names follow the stock
    google-research/bert checkpoint scope layout)."""

    def __init__(self, cfg: BertConfig, batch: int, seq_len: int, seed: int):
        self.cfg = cfg
        self.b = GraphDefBuilder()
        self.batch = batch
        self.seq = seq_len
        self.rng = np.random.RandomState(seed)
        self._uid = 0

    # -- helpers -----------------------------------------------------------
    def _w(self, name: str, shape, stddev=None) -> str:
        std = self.cfg.initializer_range if stddev is None else stddev
        return self.b.const(
            name, (self.rng.randn(*shape) * std).astype(np.float32))

    def _zeros(self, name: str, shape) -> str:
        return self.b.const(name, np.zeros(shape, np.float32))

    def _ones(self, name: str, shape) -> str:
        return self.b.const(name, np.ones(shape, np.float32))

    def _c(self, value, dtype=np.int32) -> str:
        self._uid += 1
        return self.b.const(f"const_{self._uid}", np.asarray(value, dtype))

    def dense(self, scope: str, x2d: str, n_in: int, n_out: int) -> str:
        w = self._w(f"{scope}/kernel", (n_in, n_out))
        bias = self._zeros(f"{scope}/bias", (n_out,))
        mm = self.b.node("MatMul", f"{scope}/MatMul", x2d, w,
                         transpose_a=False, transpose_b=False)
        return self.b.node("BiasAdd", f"{scope}/BiasAdd", mm, bias)

    def layer_norm(self, scope: str, x: str, width: int) -> str:
        """The frozen-graph LN pattern: Mean / SquaredDifference / Rsqrt."""
        gamma = self._ones(f"{scope}/gamma", (width,))
        beta = self._zeros(f"{scope}/beta", (width,))
        axes = self._c([-1])
        mean = self.b.node("Mean", f"{scope}/moments/mean", x, axes,
                           keep_dims=True)
        sqd = self.b.node("SquaredDifference", f"{scope}/moments/sqdiff",
                          x, mean)
        var = self.b.node("Mean", f"{scope}/moments/variance", sqd, axes,
                          keep_dims=True)
        eps = self._c(self.cfg.layer_norm_eps, np.float32)
        veps = self.b.node("AddV2", f"{scope}/add_eps", var, eps)
        rstd = self.b.node("Rsqrt", f"{scope}/Rsqrt", veps)
        norm = self.b.node("Mul", f"{scope}/mul_norm",
                           self.b.node("Sub", f"{scope}/sub", x, mean), rstd)
        scaled = self.b.node("Mul", f"{scope}/mul_gamma", norm, gamma)
        return self.b.node("AddV2", f"{scope}/out", scaled, beta)

    def gelu(self, scope: str, x: str) -> str:
        """Erf-based gelu exactly as the BERT graph emits it."""
        sqrt2 = self._c(np.sqrt(2.0), np.float32)
        xd = self.b.node("RealDiv", f"{scope}/truediv", x, sqrt2)
        e = self.b.node("Erf", f"{scope}/Erf", xd)
        one = self._c(1.0, np.float32)
        e1 = self.b.node("AddV2", f"{scope}/add", e, one)
        half = self._c(0.5, np.float32)
        xh = self.b.node("Mul", f"{scope}/mul", x, half)
        return self.b.node("Mul", f"{scope}/mul_1", xh, e1)

    # -- model -------------------------------------------------------------
    def build(self) -> bytes:
        cfg, b = self.cfg, self.b
        B, S, H = self.batch, self.seq, cfg.hidden_size
        b.placeholder("input_ids", shape=[B, S], dtype=np.int32)
        b.placeholder("input_mask", shape=[B, S], dtype=np.int32)
        b.placeholder("token_type_ids", shape=[B, S], dtype=np.int32)

        # --- embeddings ---------------------------------------------------
        word_emb = self._w("bert/embeddings/word_embeddings",
                           (cfg.vocab_size, H))
        axis0 = self._c(0)
        emb = b.node("GatherV2", "bert/embeddings/gather",
                     word_emb, "input_ids", axis0)
        # token-type: OneHot @ table (the stock graph's pattern)
        tt_table = self._w("bert/embeddings/token_type_embeddings",
                           (cfg.type_vocab_size, H))
        depth = self._c(cfg.type_vocab_size)
        on = self._c(1.0, np.float32)
        off = self._c(0.0, np.float32)
        flat_tt = b.node("Reshape", "bert/embeddings/tt_flat",
                         "token_type_ids", self._c([B * S]))
        oh = b.node("OneHot", "bert/embeddings/one_hot",
                    flat_tt, depth, on, off)
        tt2 = b.node("MatMul", "bert/embeddings/tt_matmul", oh, tt_table,
                     transpose_a=False, transpose_b=False)
        tt = b.node("Reshape", "bert/embeddings/tt_emb", tt2,
                    self._c([B, S, H]))
        emb = b.node("AddV2", "bert/embeddings/add_tt", emb, tt)
        # positions: StridedSlice of the full table
        pos_table = self._w("bert/embeddings/position_embeddings",
                            (cfg.max_position_embeddings, H))
        pos = b.raw_node(
            "bert/embeddings/pos_slice", "StridedSlice",
            [pos_table, self._c([0, 0]), self._c([S, H]), self._c([1, 1])])
        emb = b.node("AddV2", "bert/embeddings/add_pos", emb, pos)
        x = self.layer_norm("bert/embeddings/LayerNorm", emb, H)

        # --- attention mask: (1 - mask) * -10000, [B,1,1,S] ---------------
        mask_f = b.node("Cast", "bert/encoder/mask_cast", "input_mask",
                        DstT=("dtype", 1))     # AttrValue.type, as TF writes it
        mask_r = b.node("Reshape", "bert/encoder/mask_reshape", mask_f,
                        self._c([B, 1, 1, S]))
        one = self._c(1.0, np.float32)
        inv = b.node("Sub", "bert/encoder/mask_inv", one, mask_r)
        neg = self._c(-10000.0, np.float32)
        adder = b.node("Mul", "bert/encoder/mask_adder", inv, neg)

        # --- encoder layers ----------------------------------------------
        A, D = cfg.num_heads, cfg.head_size
        x2 = b.node("Reshape", "bert/encoder/flatten_in", x,
                    self._c([B * S, H]))
        for i in range(cfg.num_layers):
            sc = f"bert/encoder/layer_{i}"
            q = self.dense(f"{sc}/attention/self/query", x2, H, H)
            k = self.dense(f"{sc}/attention/self/key", x2, H, H)
            v = self.dense(f"{sc}/attention/self/value", x2, H, H)

            def heads(name, t):
                r = b.node("Reshape", f"{name}/reshape", t,
                           self._c([B, S, A, D]))
                return b.node("Transpose", f"{name}/transpose", r,
                              self._c([0, 2, 1, 3]))

            qh = heads(f"{sc}/attention/self/q", q)
            kh = heads(f"{sc}/attention/self/k", k)
            vh = heads(f"{sc}/attention/self/v", v)
            scores = b.node("BatchMatMulV2", f"{sc}/attention/self/qk",
                            qh, kh, adj_x=False, adj_y=True)
            scale = self._c(1.0 / np.sqrt(D), np.float32)
            scores = b.node("Mul", f"{sc}/attention/self/scale",
                            scores, scale)
            scores = b.node("AddV2", f"{sc}/attention/self/mask",
                            scores, adder)
            probs = b.node("Softmax", f"{sc}/attention/self/Softmax", scores)
            ctx = b.node("BatchMatMulV2", f"{sc}/attention/self/ctx",
                         probs, vh, adj_x=False, adj_y=False)
            ctx = b.node("Transpose", f"{sc}/attention/self/ctx_t", ctx,
                         self._c([0, 2, 1, 3]))
            ctx2 = b.node("Reshape", f"{sc}/attention/self/ctx_flat", ctx,
                          self._c([B * S, H]))
            attn_out = self.dense(f"{sc}/attention/output/dense", ctx2, H, H)
            attn_out = b.node("AddV2", f"{sc}/attention/output/add",
                              attn_out, x2)
            attn_out = self.layer_norm(f"{sc}/attention/output/LayerNorm",
                                       attn_out, H)
            inter = self.dense(f"{sc}/intermediate/dense", attn_out, H,
                               cfg.intermediate_size)
            inter = self.gelu(f"{sc}/intermediate/gelu", inter)
            lay_out = self.dense(f"{sc}/output/dense", inter,
                                 cfg.intermediate_size, H)
            lay_out = b.node("AddV2", f"{sc}/output/add", lay_out, attn_out)
            x2 = self.layer_norm(f"{sc}/output/LayerNorm", lay_out, H)

        seq_out = b.node("Reshape", "bert/encoder/sequence_output", x2,
                         self._c([B, S, H]))
        # --- pooler: first token -> dense tanh ----------------------------
        first = b.raw_node(
            "bert/pooler/first_token", "StridedSlice",
            [seq_out, self._c([0, 0, 0]), self._c([0, 1, 0]),
             self._c([1, 1, 1])],
            {"begin_mask": 5, "end_mask": 5, "shrink_axis_mask": 2})
        pooled = self.dense("bert/pooler/dense", first, H, H)
        b.node("Tanh", "bert/pooler/output", pooled)
        return b.build()


def build_bert_graphdef(cfg: BertConfig = BERT_BASE, batch: int = 8,
                        seq_len: int = 128, seed: int = 0) -> bytes:
    """Serialized frozen-BERT GraphDef bytes (the '.pb file')."""
    return _BertGraphBuilder(cfg, batch, seq_len, seed).build()


def bert_base(cfg: BertConfig = BERT_BASE, batch: int = 8, seq_len: int = 128,
              num_labels: Optional[int] = None, seed: int = 0,
              device: DeviceLike = None):
    """Import a frozen BERT GraphDef into a fine-tunable SameDiff graph.

    With ``num_labels`` a classifier head + softmax-CE loss over the pooled
    output is appended (the BASELINE config 4 fine-tune step); label
    placeholder name: "labels" (one-hot [batch, num_labels]).
    Returns the SameDiff; outputs: "bert/encoder/sequence_output",
    "bert/pooler/output" (+ "loss" with a head). The graph is built for
    exactly ``batch`` rows (its Reshape targets are constants).
    """
    from deeplearning4j_tpu_torch.modelimport.tf_import import import_tf_graph
    pb = build_bert_graphdef(cfg, batch, seq_len, seed)
    sd = import_tf_graph(pb, trainable="auto", device=device)
    if num_labels is not None:
        rng = np.random.RandomState(seed + 1)
        pooled = sd.get_variable("bert/pooler/output")
        w = sd.var("classifier/kernel",
                   value=(rng.randn(cfg.hidden_size, num_labels)
                          * cfg.initializer_range).astype(np.float32))
        bias = sd.var("classifier/bias",
                      value=np.zeros(num_labels, np.float32))
        logits = sd.invoke("matmul", [pooled, w], name="classifier/logits")
        logits = sd.invoke("bias_add", [logits, bias],
                           name="classifier/logits_b")
        labels = sd.placeholder("labels", shape=(batch, num_labels))
        loss = sd.invoke("softmax_cross_entropy", [logits, labels],
                         name="loss")
        sd.set_loss_variables([loss])
    return sd
