"""GPT-style autoregressive decoder built on SameDiff.

Counterpart of ``deeplearning4j_tpu/zoo/gpt.py`` (``GPTConfig`` :29,
``GPT_MEDIUM``, ``GPT_TINY``, ``build_gpt`` :71, ``gpt_param_names``
:159). The same variable names, the same numpy ``default_rng(seed)``
draws in the same order and the same per-head ``[q_a|k_a|v_a]`` layout of
the fused qkv projection, so a seed gives the JAX package's weights;
kernels are ``[n_in, n_out]`` there and here.

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
