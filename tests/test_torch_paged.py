"""The port's paged serving (``serving/paged/``, ``kernels/paged_attention``
and ``zoo/gpt.py``'s paged decode functions) against the JAX package, on
the CPU.

The JAX package's config of ``tests/test_paged.py`` (vocab 64, hidden 32,
2 layers, 2 heads, max_seq 32, blocks of 8); the same weights go into
both packages through ``convert.samediff_arrays_from_jax``, float32 on
both sides. On the CPU ``paged_attention`` runs its plain version.

Tolerances: logits and the K/V rows written are held to the JAX
functions at 1e-5 of their largest magnitude (float32 sums in another
order; with x64 on, the JAX softmax runs in float64 because its scale is
a numpy float64). Only real rows are compared: the JAX prefill also
zeroes the K/V of rows at or past ``hist + length``, which changes only
padded rows, whose outputs reach no real row and no logit.
``paged_attention_plain`` against the JAX attention expression: 1e-6.
Inside the port, paged and dense serving give the same tokens bit for
bit. The server's greedy tokens equal the JAX package's ``greedy_decode``.
"""
import contextlib
import ctypes
import pathlib
import re
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.serving.generative import \
    greedy_decode as jax_greedy_decode
from deeplearning4j_tpu.zoo import gpt as jgpt
from deeplearning4j_tpu_torch.convert import samediff_arrays_from_jax
from deeplearning4j_tpu_torch.kernels import _cuda
from deeplearning4j_tpu_torch.kernels import paged_attention as pa
from deeplearning4j_tpu_torch.serving.generative import (GenerativeServer,
                                                        greedy_decode)
from deeplearning4j_tpu_torch.serving.paged import (NULL_BLOCK, BlockPool,
                                                    PagedGenerativeServer,
                                                    PagedMetrics,
                                                    PoolExhaustedError,
                                                    blocks_for_tokens,
                                                    prefix_block_hashes)
from deeplearning4j_tpu_torch.serving.resilience import ResilienceConfig
from deeplearning4j_tpu_torch.zoo import gpt as pgpt

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "deeplearning4j_tpu_torch" / "csrc" / "paged_attention.cu"
MSL = 32
BS = 8
MAXB = MSL // BS
JCFG = jgpt.GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                      num_heads=2, intermediate_size=64, max_seq_len=MSL)
PCFG = pgpt.GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                      num_heads=2, intermediate_size=64, max_seq_len=MSL)


@pytest.fixture(scope="module")
def jsd():
    return jgpt.build_gpt(JCFG, batch=2, seq_len=8, seed=0)


@pytest.fixture(scope="module")
def psd(jsd):
    sd = pgpt.build_gpt(PCFG, batch=2, seq_len=8, seed=3, device="cpu")
    return samediff_arrays_from_jax(
        {n: np.asarray(a, np.float32)
         for n, a in jsd.trainable_params().items()}, sd)


@pytest.fixture(scope="module")
def spec(psd):
    return pgpt.gpt_paged_spec(psd, PCFG)


@pytest.fixture(scope="module")
def dense_spec(psd):
    return pgpt.gpt_generative_spec(psd, PCFG)


def make_server(spec, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_seq_len", MSL)
    kw.setdefault("block_size", BS)
    kw.setdefault("warmup", False)
    kw.setdefault("debug_leaks", True)
    kw.setdefault("device", "cpu")
    return PagedGenerativeServer(spec, **kw)


def ref_tokens(dense_spec, prompt, n):
    return greedy_decode(dense_spec, prompt, n, max_seq_len=MSL,
                         device="cpu")


def mixed_prompts(n=6, seed=0, max_len=12):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, PCFG.vocab_size,
                         int(rng.integers(1, max_len + 1)))
            .astype(np.int32) for _ in range(n)]


def wait_uncommitted(srv, timeout=10.0):
    """The block commitment is released by the request future's done
    callback, which runs after result() waiters wake."""
    deadline = time.monotonic() + timeout
    while srv._committed and time.monotonic() < deadline:
        time.sleep(0.01)
    return srv._committed


def _close(got, want, rtol=1e-5):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= rtol * max(float(np.max(np.abs(want))), 1e-30), err


# ----------------------------------------------------------------------
# the decode functions against the JAX package's
class _Both:
    """The JAX and the port's paged prefill/decode over slabs of the same
    random contents, driven with the same io."""

    def __init__(self, jsd, psd, num_blocks=12, seed=0):
        self.jf = jgpt.gpt_paged_decode_fns(JCFG, BS, MAXB)
        self.pf = pgpt.gpt_paged_decode_fns(PCFG, BS, MAXB)
        names = jgpt.gpt_param_names(JCFG)
        self.jp = {n: jsd._arrays[n] for n in names}
        self.pp = {n: psd.get_arr_for_var(n) for n in names}
        shape = (2, num_blocks, 2, BS, 16)
        rng = np.random.default_rng(seed)
        k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
        self.j = [jnp.asarray(k), jnp.asarray(v)]
        self.p = [torch.from_numpy(k.copy()), torch.from_numpy(v.copy())]

    def run(self, kind, io):
        fn = 0 if kind == "prefill" else 1
        jkc, jvc, jn, jl = self.jf[fn](self.jp, *self.j, io)
        self.j = [jkc, jvc]
        with torch.inference_mode():
            pkc, pvc, pn, pl = self.pf[fn](self.pp, *self.p, io)
        assert pkc is self.p[0] and pvc is self.p[1]      # in place
        return (np.asarray(jn), np.asarray(jl)), (pn.numpy(), pl)


def _prefill_io(prompt, hist, table):
    suffix = prompt[hist:]
    lb = 1 << max(0, int(len(suffix) - 1).bit_length())
    padded = np.zeros(lb, np.int32)
    padded[:len(suffix)] = suffix
    return {"tokens": padded, "length": np.int32(len(suffix)),
            "hist": np.int32(hist), "table": np.asarray(table, np.int32)}


def test_paged_prefill_cold_then_with_a_prefix_hit_matches_jax(jsd, psd):
    both = _Both(jsd, psd)
    prompt = np.arange(13, dtype=np.int32) * 5 % 64
    # cold: 13 tokens into blocks 3 and 7
    (jn, jl), (pn, pl) = both.run("prefill", _prefill_io(
        prompt, 0, [3, 7, 0, 0]))
    _close(pl, jl)
    assert int(pn) == int(jn)
    # a prefix hit: block 3 reused (hist 8), the suffix into blocks 9, 10
    longer = np.concatenate([prompt[:8], np.arange(11, dtype=np.int32)])
    (jn, jl), (pn, pl) = both.run("prefill", _prefill_io(
        longer, 8, [3, 9, 10, 0]))
    _close(pl, jl)
    assert int(pn) == int(jn)
    # every block but the null one (where JAX writes the padded rows)
    for jt, pt in zip(both.j, both.p):
        _close(pt[:, 1:], np.asarray(jt)[:, 1:])


def test_paged_decode_matches_jax_with_inactive_lanes(jsd, psd):
    both = _Both(jsd, psd, seed=1)
    tables = np.array([[1, 2, 0, 0], [4, 5, 6, 0], [0, 0, 0, 0],
                       [8, 0, 0, 0]], np.int32)
    pos = np.array([9, 17, 5, 0], np.int32)
    active = np.array([True, True, False, True])
    wb = np.where(active, tables[np.arange(4), pos // BS], NULL_BLOCK)
    io = {"tokens": np.array([3, 60, 7, 1], np.int32), "positions": pos,
          "active": active, "tables": tables,
          "write_block": wb.astype(np.int32),
          "write_off": np.where(active, pos % BS, 0).astype(np.int32)}
    null_before = both.p[0][:, NULL_BLOCK].clone()
    (jn, jl), (pn, pl) = both.run("decode", io)
    _close(pl[active], np.asarray(jl)[active])
    np.testing.assert_array_equal(pn[active], jn[active])
    # the active lanes' rows: written as JAX writes them
    for jt, pt in zip(both.j, both.p):
        for s in np.flatnonzero(active):
            _close(pt[:, wb[s], :, pos[s] % BS],
                   np.asarray(jt)[:, wb[s], :, pos[s] % BS])
    # an inactive lane writes nothing (JAX writes it to the null block)
    assert torch.equal(both.p[0][:, NULL_BLOCK], null_before)


def test_dense_decode_over_paged_attention_matches_jax(jsd, psd):
    jpre, jdec, _ = jgpt.gpt_decode_fns(JCFG)
    ppre, pdec, _ = pgpt.gpt_decode_fns(PCFG)
    names = jgpt.gpt_param_names(JCFG)
    jp = {n: jsd._arrays[n] for n in names}
    pp = {n: psd.get_arr_for_var(n) for n in names}
    rng = np.random.default_rng(2)
    kv = [rng.normal(size=(2, 3, 2, MSL, 16)).astype(np.float32)
          for _ in range(2)]
    jkv = [jnp.asarray(a) for a in kv]
    pkv = [torch.from_numpy(a.copy()) for a in kv]
    io = {"tokens": np.array([5, 9, 30], np.int32),
          "positions": np.array([4, 31, 12], np.int32),
          "active": np.array([True, False, True])}
    jkc, jvc, jn, jl = jdec(jp, *jkv, io)
    with torch.inference_mode():
        pkc, pvc, pn, pl = pdec(pp, *pkv, io)
    act = io["active"]
    _close(pl[act], np.asarray(jl)[act])
    np.testing.assert_array_equal(pn.numpy()[act], np.asarray(jn)[act])
    _close(pkc, np.asarray(jkc))
    _close(pvc, np.asarray(jvc))


def test_dense_prefill_matches_jax_logits_and_rows(jsd, psd):
    jpre, _, _ = jgpt.gpt_decode_fns(JCFG)
    ppre, _, _ = pgpt.gpt_decode_fns(PCFG)
    names = jgpt.gpt_param_names(JCFG)
    prompt = np.array([5, 17, 40, 2, 33], np.int32)
    io = {"tokens": np.pad(prompt, (0, 3)), "length": np.int32(5),
          "slot": np.int32(1)}
    z = np.zeros((2, 2, 2, MSL, 16), np.float32)
    jkc, jvc, jn, jl = jpre({n: jsd._arrays[n] for n in names},
                            jnp.asarray(z), jnp.asarray(z), io)
    with torch.inference_mode():
        pkc, pvc, pn, pl = ppre({n: psd.get_arr_for_var(n) for n in names},
                                torch.zeros(z.shape), torch.zeros(z.shape),
                                io)
    _close(pl, np.asarray(jl))
    assert int(pn) == int(jn)
    _close(pkc, np.asarray(jkc))
    _close(pvc, np.asarray(jvc))


# ----------------------------------------------------------------------
# paged_attention_plain against the JAX attention expressions
def _jax_decode_attention(q, kc, vc, tables, pos):
    """zoo/gpt.py gpt_paged_decode_fns.decode_fn :675-689."""
    S, A, D = q.shape
    T = tables.shape[1] * kc.shape[2]
    ctx_k = jnp.transpose(kc[tables], (0, 2, 1, 3, 4)).reshape(S, A, T, D)
    ctx_v = jnp.transpose(vc[tables], (0, 2, 1, 3, 4)).reshape(S, A, T, D)
    mask = jnp.arange(T)[None, None, :] <= pos[:, None, None]
    scores = jnp.einsum("sad,satd->sat", q, ctx_k,
                        preferred_element_type=jnp.float32) / np.sqrt(D)
    scores = jnp.where(mask, scores, jnp.float32(-1e30))
    probs = jax_softmax(scores).astype(ctx_v.dtype)
    v_safe = jnp.where(mask[..., None], ctx_v, 0)
    return jnp.einsum("sat,satd->sad", probs, v_safe)


def _jax_prefill_attention(q, kc, vc, table, hist, length):
    """zoo/gpt.py gpt_paged_decode_fns.prefill_fn :621-636 (q [Lb, A, D])."""
    Lb, A, D = q.shape
    T = table.shape[0] * kc.shape[2]
    g = hist + jnp.arange(Lb)
    cm = jnp.arange(T)[None, :] <= g[:, None]
    valid = jnp.arange(T) < hist + length
    ctx_k = jnp.transpose(kc[table], (1, 0, 2, 3)).reshape(A, T, D)
    ctx_v = jnp.transpose(vc[table], (1, 0, 2, 3)).reshape(A, T, D)
    ctx_k = jnp.where(valid[:, None], ctx_k, 0)
    ctx_v = jnp.where(valid[:, None], ctx_v, 0)
    scores = jnp.einsum("aqd,akd->aqk", jnp.transpose(q, (1, 0, 2)), ctx_k,
                        preferred_element_type=jnp.float32) / np.sqrt(D)
    scores = jnp.where(cm[None], scores, jnp.float32(-1e30))
    probs = jax_softmax(scores).astype(ctx_v.dtype)
    return jnp.transpose(jnp.einsum("aqk,akd->aqd", probs, ctx_v),
                         (1, 0, 2))


def jax_softmax(x):
    import jax
    return jax.nn.softmax(x, axis=-1)


def _cache(nb, a, bs, d, seed, poison=()):
    rng = np.random.default_rng(seed)
    kc, vc = (rng.normal(size=(nb, a, bs, d)).astype(np.float32)
              for _ in range(2))
    for b in poison:
        kc[b] = vc[b] = np.nan
    return kc, vc


@pytest.mark.parametrize("bs,d", [(8, 16), (1, 32), (5, 16), (16, 64)])
def test_plain_decode_matches_the_jax_expression(bs, d):
    maxb = -(-40 // bs)
    nb = 4 * maxb + 2
    kc, vc = _cache(nb, 3, bs, d, seed=bs, poison=(NULL_BLOCK, nb - 1))
    rng = np.random.default_rng(d)
    pos = np.array([0, bs - 1, bs, 39], np.int32)
    tables = np.zeros((4, maxb), np.int32)
    for s in range(4):
        n = pos[s] // bs + 1
        tables[s, :n] = 1 + s * maxb + np.arange(n)
    q = rng.normal(size=(4, 3, d)).astype(np.float32)
    want = _jax_decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                 jnp.asarray(vc), jnp.asarray(tables),
                                 jnp.asarray(pos))
    got = pa.paged_attention(torch.from_numpy(q), torch.from_numpy(kc),
                             torch.from_numpy(vc), torch.from_numpy(tables),
                             torch.arange(4, dtype=torch.int32),
                             torch.from_numpy(pos))
    assert torch.isfinite(got).all()
    _close(got, np.asarray(want), rtol=1e-6)
    assert pa.LAUNCHES["paged_attention"] == 0       # nothing launched


@pytest.mark.parametrize("hist,length,lb", [(0, 5, 8), (8, 9, 16),
                                            (16, 1, 1)])
def test_plain_prefill_matches_the_jax_expression(hist, length, lb):
    kc, vc = _cache(9, 2, BS, 16, seed=hist, poison=(NULL_BLOCK, 8))
    table = np.array([3, 1, 6, 0], np.int32)
    rng = np.random.default_rng(length)
    q = rng.normal(size=(lb, 2, 16)).astype(np.float32)
    want = np.asarray(_jax_prefill_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(table),
        hist, length))
    # the port's prefill hands padded rows the last real row's last key
    kmax = hist + np.minimum(np.arange(lb), length - 1)
    got = pa.paged_attention(torch.from_numpy(q), torch.from_numpy(kc),
                             torch.from_numpy(vc),
                             torch.from_numpy(table[None]),
                             torch.zeros(lb, dtype=torch.int32),
                             torch.from_numpy(kmax.astype(np.int32)))
    _close(got[:length], want[:length], rtol=1e-6)


def test_plain_reads_no_key_past_a_row_s_last():
    """NaN in every block past each row's last key, in the tail of its
    last block and in the null block: the output is finite and equal to
    the clean cache's."""
    kc, vc = _cache(6, 2, 4, 16, seed=9)
    tables = np.array([[2, 3, 0], [5, 0, 0]], np.int32)
    kmax = np.array([5, 2], np.int32)
    args = [torch.from_numpy(tables), torch.arange(2, dtype=torch.int32),
            torch.from_numpy(kmax)]
    q = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 2, 16)).astype(np.float32))
    clean = pa.paged_attention(q, torch.from_numpy(kc), torch.from_numpy(vc),
                               *args)
    for a in (kc, vc):
        a[0] = a[1] = a[4] = np.nan
        a[3, :, 2:] = np.nan           # lane 0's last key is row 1 of block 3
        a[5, :, 3:] = np.nan
    got = pa.paged_attention(q, torch.from_numpy(kc), torch.from_numpy(vc),
                             *args)
    assert torch.equal(got, clean)


def test_abs_terms_bound_the_plain_version():
    kc, vc = _cache(5, 2, 4, 16, seed=4)
    tables = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)
    q = torch.randn(3, 2, 16, dtype=torch.float64)
    lane = torch.zeros(3, dtype=torch.int32)
    kmax = torch.tensor([0, 7, 15], dtype=torch.int32)
    kcd, vcd = torch.from_numpy(kc).double(), torch.from_numpy(vc).double()
    out = pa.paged_attention(q, kcd, vcd, tables, lane, kmax)
    terms = pa.abs_terms(q, kcd, vcd, tables, lane, kmax)
    assert (out.abs() <= terms + 1e-12).all()
    # row 0 attends to key 0 alone: its terms are |V[0]|
    assert torch.allclose(terms[0], vcd[1, :, 0].abs())


@pytest.mark.parametrize("bad,match", [
    (dict(q=torch.zeros(2, 3, 16)), "does not match"),
    (dict(vc=torch.zeros(4, 2, 8, 32)), "must be"),
    (dict(lane=torch.zeros(3, dtype=torch.int32)), "lane"),
    (dict(q=torch.zeros(2, 2, 16, dtype=torch.float64)), "dtypes differ"),
])
def test_wrapper_refuses_mismatched_inputs(bad, match):
    args = dict(q=torch.zeros(2, 2, 16), kc=torch.zeros(4, 2, 8, 16),
                vc=torch.zeros(4, 2, 8, 16),
                tables=torch.zeros(2, 3, dtype=torch.int32),
                lane=torch.zeros(2, dtype=torch.int32),
                kmax=torch.zeros(2, dtype=torch.int32))
    args.update(bad)
    with pytest.raises(ValueError, match=match):
        pa.paged_attention(**args)


# ----------------------------------------------------------------------
# paged_decode_plain (the step's K/V write, then the attention) against
# the JAX decode functions' write-then-attend
def _jax_paged_write(kc, vc, k, v, wb, wo):
    """zoo/gpt.py gpt_paged_decode_fns.decode_fn :668-674 (the scatter)."""
    ai = jnp.arange(k.shape[1])
    kc = kc.at[wb[:, None], ai[None, :], wo[:, None]].set(k)
    vc = vc.at[wb[:, None], ai[None, :], wo[:, None]].set(v)
    return kc, vc


def _jax_dense_write(kc, vc, k, v, pos, active):
    """zoo/gpt.py gpt_decode_fns.decode_fn :375-382 (the masked per-slot
    write), one layer's slab [S, A, T, D]."""
    si = jnp.arange(k.shape[0])[:, None]
    ai = jnp.arange(k.shape[1])[None, :]
    at = (si, ai, pos[:, None])
    kc = kc.at[at].set(jnp.where(active[:, None, None], k, kc[at]))
    vc = vc.at[at].set(jnp.where(active[:, None, None], v, vc[at]))
    return kc, vc


def _step_rows(n, a, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n, a, d)).astype(np.float32) for _ in range(3)]


def _i32(x):
    return torch.from_numpy(np.asarray(x, np.int32))


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("bs", [1, 16, 1024])
def test_plain_decode_write_matches_the_jax_paged_decode(bs, d):
    """Lanes at key 0, at a block's last row, at the next block's first and
    inside a block, one of them inactive (the JAX scatter sends it to the
    null block; the port writes nothing): outputs of the active lanes
    within 1e-6, the written rows bit for bit, the null block untouched."""
    maxb = -(-40 // bs)
    nb = 4 * maxb + 2
    kc, vc = _cache(nb, 3, bs, d, seed=bs + d, poison=(nb - 1,))
    pos = np.minimum([0, bs - 1, bs, 39], 39).astype(np.int32)
    active = np.array([True, True, False, True])
    tables = np.zeros((4, maxb), np.int32)
    for s in range(4):
        n = pos[s] // bs + 1
        tables[s, :n] = 1 + s * maxb + np.arange(n)
    q, k, v = _step_rows(4, 3, d, seed=d)
    wb = np.where(active, tables[np.arange(4), pos // bs], NULL_BLOCK)
    wo = np.where(active, pos % bs, 0)
    jkc, jvc = _jax_paged_write(jnp.asarray(kc), jnp.asarray(vc),
                                jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(wb), jnp.asarray(wo))
    want = _jax_decode_attention(jnp.asarray(q), jkc, jvc,
                                 jnp.asarray(tables), jnp.asarray(pos))
    pkc, pvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got = pa.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), pkc,
        pvc, _i32(tables), torch.arange(4, dtype=torch.int32),
        _i32(np.where(active, pos, 0)), _i32(np.where(active, wb, -1)),
        _i32(wo))
    assert torch.isfinite(got[active]).all()
    _close(got[active], np.asarray(want)[active], rtol=1e-6)
    for pt, jt, orig in ((pkc, jkc, kc), (pvc, jvc, vc)):
        np.testing.assert_array_equal(pt[1:].numpy(), np.asarray(jt)[1:])
        np.testing.assert_array_equal(pt[NULL_BLOCK].numpy(), orig[0])
    assert pa.LAUNCHES["paged_decode_attention"] == 0    # nothing launched


@pytest.mark.parametrize("d,t", [(16, 40), (32, 40), (64, 40), (128, 40),
                                 (128, 1024)])
def test_plain_decode_write_matches_the_jax_dense_decode(d, t):
    """The dense slab as a paged one (``BS = max_seq``, table ``[s]``,
    ``write_block = s``, ``write_off = position``; an inactive slot -1):
    the active slots' outputs within 1e-6 of the JAX dense decode's, and
    the whole slab after the write bit for bit (both keep an inactive
    slot's rows)."""
    rng = np.random.default_rng(d + t)
    kc, vc = (rng.normal(size=(3, 2, t, d)).astype(np.float32)
              for _ in range(2))
    pos = np.array([4, t - 1, 12], np.int32)
    active = np.array([True, False, True])
    q, k, v = _step_rows(3, 2, d, seed=t)
    jkc, jvc = _jax_dense_write(jnp.asarray(kc), jnp.asarray(vc),
                                jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(pos), jnp.asarray(active))
    slots = np.arange(3)
    want = _jax_decode_attention(jnp.asarray(q), jkc, jvc,
                                 jnp.asarray(slots[:, None]),
                                 jnp.asarray(pos))
    pkc, pvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got = pa.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), pkc,
        pvc, _i32(slots[:, None]), _i32(slots),
        _i32(np.where(active, pos, 0)), _i32(np.where(active, slots, -1)),
        _i32(pos))
    _close(got[active], np.asarray(want)[active], rtol=1e-6)
    np.testing.assert_array_equal(pkc.numpy(), np.asarray(jkc))
    np.testing.assert_array_equal(pvc.numpy(), np.asarray(jvc))


@pytest.mark.parametrize("bad,match", [
    (dict(k_new=torch.zeros(2, 2, 8)), "must be q's"),
    (dict(v_new=torch.zeros(2, 2, 16, dtype=torch.float64)), "dtypes"),
    (dict(write_block=torch.zeros(3, dtype=torch.int32)), "write_block"),
    (dict(write_off=torch.zeros(2, 1, dtype=torch.int32)), "write_off"),
])
def test_decode_wrapper_refuses_mismatched_writes(bad, match):
    args = dict(q=torch.zeros(2, 2, 16), k_new=torch.zeros(2, 2, 16),
                v_new=torch.zeros(2, 2, 16), kc=torch.zeros(4, 2, 8, 16),
                vc=torch.zeros(4, 2, 8, 16),
                tables=torch.zeros(2, 3, dtype=torch.int32),
                lane=torch.zeros(2, dtype=torch.int32),
                kmax=torch.zeros(2, dtype=torch.int32),
                write_block=torch.zeros(2, dtype=torch.int32),
                write_off=torch.zeros(2, dtype=torch.int32))
    args.update(bad)
    with pytest.raises(ValueError, match=match):
        pa.paged_decode_attention(**args)


def _decode_run(psd, kind):
    """One decode step of the port's paged or dense decode function over
    random slabs (lane 2 inactive): (io, kc, vc, the function's result)."""
    names = jgpt.gpt_param_names(JCFG)
    pp = {n: psd.get_arr_for_var(n) for n in names}
    rng = np.random.default_rng(5)
    if kind == "paged":
        fn = pgpt.gpt_paged_decode_fns(PCFG, BS, MAXB)[1]
        shape = (2, 12, 2, BS, 16)
        tables = np.array([[1, 2, 0, 0], [4, 5, 6, 0], [0, 0, 0, 0],
                           [8, 0, 0, 0]], np.int32)
        pos = np.array([9, 17, 5, 0], np.int32)
        active = np.array([True, True, False, True])
        io = {"tables": tables, "write_block": np.where(
                  active, tables[np.arange(4), pos // BS], NULL_BLOCK
              ).astype(np.int32),
              "write_off": np.where(active, pos % BS, 0).astype(np.int32)}
    else:
        fn = pgpt.gpt_decode_fns(PCFG)[1]
        shape = (2, 4, 2, MSL, 16)
        pos = np.array([4, 31, 5, 12], np.int32)
        active = np.array([True, True, False, True])
        io = {}
    io.update(tokens=np.array([3, 60, 7, 1], np.int32), positions=pos,
              active=active)
    kc, vc = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
              for _ in range(2))
    with torch.inference_mode():
        return io, kc, vc, fn(pp, kc, vc, io)


@pytest.mark.parametrize("kind", ["paged", "dense"])
def test_decode_fns_write_and_attend_in_one_launch_a_layer(monkeypatch,
                                                           psd, kind):
    """With the card's launch stubbed (the wrapper's checks pass as for a
    CUDA tensor), each decode function calls ``paged_decode_attention``
    once a layer, which launches once with the step's rows and write
    places, and calls ``index_put_`` never; an inactive lane writes
    nothing (``write_block`` -1) and attends to key 0."""
    launches, puts = [], []
    monkeypatch.setattr(pa, "_check", lambda q, *a: types.SimpleNamespace(
        type="cuda"))
    monkeypatch.setattr(pa, "_check_write", lambda *a: None)
    monkeypatch.setattr(pa, "_launch", lambda q, kc, vc, tables, lane, kmax,
                        write=None, **kw: launches.append(
                            (kc.data_ptr(), tables, lane, kmax, write))
                        or torch.zeros_like(q))
    real_put = torch.Tensor.index_put_
    monkeypatch.setattr(torch.Tensor, "index_put_", lambda self, *a, **kw: (
        puts.append(1), real_put(self, *a, **kw))[1])
    pa.reset_launches()
    io, kc, vc, _ = _decode_run(psd, kind)
    layers = PCFG.num_layers
    assert pa.LAUNCHES == {"paged_attention": 0,
                           "paged_decode_attention": layers,
                           "paged_verify_attention": 0}
    assert len(launches) == layers and puts == []
    act = io["active"]
    pos = io["positions"]
    for i, (ptr, tables, lane, kmax, write) in enumerate(launches):
        assert ptr == kc[i].data_ptr()
        k_new, v_new, wb, wo = write
        assert k_new.shape == v_new.shape == (4, 2, 16)
        np.testing.assert_array_equal(kmax.numpy(), np.where(act, pos, 0))
        want_wb = io["write_block"] if kind == "paged" else np.arange(4)
        np.testing.assert_array_equal(wb.numpy(), np.where(act, want_wb, -1))
        np.testing.assert_array_equal(
            wo.numpy()[act], (pos % BS if kind == "paged" else pos)[act])


@pytest.mark.parametrize("kind", ["paged", "dense"])
def test_decode_fns_keep_the_write_contract(monkeypatch, spec, dense_spec,
                                            kind):
    """Every decode step the servers run writes each active lane's K/V row
    where its last key lies through its table, ``(write_block, write_off)
    == (tables[lane, kmax // BS], kmax % BS)``: the place whose K and V the
    kernel takes from the step's rows instead of reading them back."""
    seen = []
    real = pa.paged_decode_attention

    def spy(q, k_new, v_new, kc, vc, tables, lane, kmax, wb, wo, *scales):
        bs = kc.shape[2]
        for r in torch.nonzero(wb >= 0).flatten().tolist():
            t = int(kmax[r])
            seen.append((int(wb[r]), int(wo[r])) == (
                int(tables[lane[r], t // bs]), t % bs))
        return real(q, k_new, v_new, kc, vc, tables, lane, kmax, wb, wo,
                    *scales)
    monkeypatch.setattr(pa, "paged_decode_attention", spy)
    prompts = mixed_prompts(3, seed=4, max_len=16)
    if kind == "paged":
        with make_server(spec) as srv:
            hs = [srv.submit(p, max_new_tokens=12) for p in prompts]
            [h.result(timeout=60) for h in hs]
    else:
        with GenerativeServer(dense_spec, max_slots=4, max_seq_len=MSL,
                              warmup=False, device="cpu") as srv:
            hs = [srv.submit(p, max_new_tokens=12) for p in prompts]
            [h.result(timeout=60) for h in hs]
    assert len(seen) > 20 and all(seen)


def test_decode_launch_passes_the_write_and_the_geometry(monkeypatch):
    """``_launch`` hands the C entry null write pointers for
    ``paged_attention``, the four write tensors for a decode step, and the
    cache's and the table's geometry and strides."""
    calls = []

    class Entry:
        def __call__(self, *a):
            calls.append(a)
            return 0

    lib = types.SimpleNamespace(**{pa.ENTRY: Entry()})
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 7, raising=False)
    q, k, v = (torch.zeros(3, 2, 16) for _ in range(3))
    kc, vc = torch.zeros(9, 2, 16, 16), torch.zeros(9, 2, 16, 16)
    tables = torch.zeros(3, 64, dtype=torch.int32)
    ints = [torch.zeros(3, dtype=torch.int32) for _ in range(4)]
    pa._launch(q, kc, vc, tables, *ints[:2], lib=lib)
    pa._launch(q, kc, vc, tables, *ints[:2], write=(k, v, *ints[2:]), lib=lib)
    names = [n for n, _ in pa.DECODE_ARGTYPES]
    plain, write = (dict(zip(names, c)) for c in calls)
    assert [plain[n] for n in ("k_new", "v_new", "write_block",
                               "write_off")] == [None] * 4
    assert write["k_new"] == k.data_ptr() and write["write_off"] == \
        ints[3].data_ptr()
    for c in (plain, write):
        assert (c["N"], c["A"], c["D"], c["BS"], c["MAXB"], c["NB"],
                c["S"]) == (3, 2, 16, 16, 64, 9, 3)
        assert (c["skb"], c["ska"], c["skt"]) == kc.stride()[:3]
        assert c["stream"] == 7
        assert c["dtype"] == 1 and c["scale"] == 0.25


def test_decode_case_builder_and_its_controls():
    """``measure.paged_decode_write_case`` (what chip_smoke.py and the card
    tests hand the kernel) writes each active lane at its last key's place;
    NaN where the step writes changes nothing; and the controls the chip
    run must see fail the 1e-5 rule: a write one offset off, and one chunk
    of 16 keys dropped."""
    from deeplearning4j_tpu_torch.kernels import measure
    cpu = torch.device("cpu")
    case = measure.paged_decode_write_case(
        cpu, [0, 15, 16, 17, 40, 100], 2, 16, 16, torch.float64,
        active=[True, True, True, False, True, True], seed=2)
    q, k_new, v_new, kc, vc, tables, lane, kmax, wb, wo = case
    assert wb.tolist()[3] == -1 and kmax.tolist()[3] == 0
    k1, v1 = kc.clone(), vc.clone()
    out = pa.paged_decode_attention(q, k_new, v_new, k1, v1, tables, lane,
                                    kmax, wb, wo)
    for r in (0, 1, 2, 4, 5):
        t = int(kmax[r])
        blk = int(tables[r, t // 16])
        assert torch.equal(k1[blk, :, t % 16], k_new[r])
        assert torch.equal(v1[blk, :, t % 16], v_new[r])
    terms = pa.abs_terms(q, k1, v1, tables, lane, kmax)
    pk, pv = measure.paged_write_poisoned(kc, vc, wb, wo)
    poisoned = pa.paged_decode_attention(q, k_new, v_new, pk, pv, tables,
                                         lane, kmax, wb, wo)
    assert torch.equal(poisoned, out)
    off = pa.paged_decode_plain(q, k_new, v_new, kc.clone(), vc.clone(),
                                tables, lane, kmax, wb,
                                torch.where(wb >= 0, (wo + 1) % 16, wo))
    assert measure.paged_reading(off, out, terms, 1e-5) > 1
    dropped = measure.paged_chunk_dropped(q, k1, v1, tables, lane, kmax, 1)
    assert measure.paged_reading(dropped, out, terms, 1e-5) > 1
    full = measure.paged_chunk_dropped(q, k1, v1, tables, lane, kmax, 99)
    assert measure.paged_reading(full, out, terms, 1e-5) <= 1
    ops, nbytes = measure.paged_bounds(q, kc, tables, lane, kmax, writes=5)
    _, plain_bytes = measure.paged_bounds(q, kc, tables, lane, kmax)
    assert nbytes - plain_bytes == 4 * 5 * 2 * 16 * 8


def _c_entry_params(entry):
    src = SRC.read_text()
    m = re.search(r'extern "C" int ' + entry + r'\((.*?)\)\s*\{', src, re.S)
    params = [p.strip() for p in m.group(1).split(",")]
    return [(" ".join(p.split()[:-1]), p.split()[-1]) for p in params]


@pytest.mark.parametrize("entry,pointers", [
    (pa.ENTRY, ["q", "k_new", "v_new", "kc", "vc", "k_scale", "v_scale",
                "tables", "lane", "kmax", "write_block", "write_off", "out",
                "stream"]),
    (pa.VERIFY_ENTRY, ["q", "k_new", "v_new", "kc", "vc", "k_scale",
                       "v_scale", "tables", "lane", "kmax", "win0", "wrow",
                       "write_block", "write_off", "out", "stream"]),
    (pa.OCCUPANCY_ENTRY, ["blocks"])])
def test_ctypes_declaration_matches_the_c_entry(entry, pointers):
    c_types = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
               "int*": ctypes.c_void_p, "int64_t": ctypes.c_int64,
               "int": ctypes.c_int, "double": ctypes.c_double}
    params = _c_entry_params(entry)
    argtypes = pa.ENTRIES[entry]
    assert [n for _, n in params] == [n for n, _ in argtypes]
    assert [c_types[t] for t, _ in params] == [t for _, t in argtypes]
    assert [n for t, n in params if t.endswith("*")] == pointers


def test_the_source_defines_exactly_the_declared_entries():
    found = re.findall(r'extern "C" int (\w+)\(', SRC.read_text())
    assert sorted(found) == sorted(pa.ENTRIES)


def test_loading_the_library_declares_the_entry(monkeypatch):
    class Entry:
        argtypes = None
        restype = ctypes.c_int

    class Lib:
        dl4j_paged_decode_attention = Entry()
        dl4j_paged_verify_attention = Entry()
        dl4j_paged_decode_occupancy = Entry()

    lib = Lib()
    monkeypatch.setattr(_cuda, "load", lambda name: lib)
    assert pa._lib() is lib
    for name, argtypes in pa.ENTRIES.items():
        fn = getattr(lib, name)
        assert fn.argtypes == [t for _, t in argtypes]
        assert fn.restype is ctypes.c_int


def test_nvcc_command_builds_the_paged_source_for_sm90a():
    out = _cuda.library_path("paged_attention")
    cmd = _cuda.build_command("paged_attention", out, "nvcc")
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert cmd[-1] == str(SRC)
    assert re.fullmatch(r"libpaged_attention-[0-9a-f]{16}\.so",
                        pathlib.Path(out).name)


def _kernel_code():
    """The cluster kernel's body, comments stripped."""
    code = "\n".join(line.split("//")[0] for line in
                     SRC.read_text().splitlines())
    start = code.index("paged_decode_kernel(const Args a)")
    return code, code[start:code.index("cudaError_t configure()", start)]


def test_kernel_sums_in_an_order_set_by_key_position_alone():
    """The cluster kernel cuts a row's keys by position alone: chunk c
    (positions 16 c .. 16 c + 15) goes to cluster rank c % 8 (rank j takes
    chunks j, j + 8, ...) and key t to stream (t % 16) % S of that block;
    the block combines its streams in stream order, and rank 0 the
    cluster's 8 partials in rank order once the other ranks have pushed
    theirs over distributed shared memory. BS is read only to address a
    key and to choose how a chunk is copied, and the source has no
    atomic. Over an int8 cache in float32 the scales leave the loop
    (``kFold``) without moving a sum: q * s_k is taken once a row, every
    key and value is read as its stored integer (the step's own key too),
    and rank 0's combine multiplies the rank-ordered sum by s_v; in
    float64 (and for a float cache) no fold."""
    code, body = _kernel_code()
    assert "static constexpr bool kFold = sizeof(C) == 1 && sizeof(T) == 4;" \
        in code
    assert "qr[j][e] = fold<L::kFold>(qp[d], scales(0, d));" in body
    assert "kn[j][e] = loaded<L::kFold, T>(kst[j][e], scales(0, d));" in body
    assert body.count("ldkv<L::kFold, T, E>(") == 2
    assert "res = fold<L::kFold>(oc, scales(1, tid)) / lc;" in body
    # the fold multiplies once, rounded, and reads raw integers
    assert "v[e] = kRaw ? static_cast<T>(xs[e])" in code
    assert "return __fmul_rn(x, *s);" in code
    assert "__cluster_dims__(kRanks, 1, 1)" in code
    assert "constexpr int kChunk = 16;" in code
    assert "constexpr int kRanks = 8;" in code
    assert (pa.CHUNK, pa.RANKS) == (16, 8)
    assert "const int c = rank + kRanks * k;" in body
    assert "const int t0 = (rank + kRanks * k) * kChunk;" in body
    assert body.count("const int i = (sid + S * jj) & (kChunk - 1);") == 2
    assert "for (int i = 0; i < S; ++i)" in body
    # the combine: ranks 1-7 push their partials into rank 0's part_acc
    # over DSMEM, rank 0 sums them in rank order once they have landed
    assert "cluster_addr(smem_u32(&part_acc[rank][tid * E]), 0)" in body
    assert "mbar_wait(smem_u32(&cbar), 0);" in body
    assert "for (int r = 0; r < kRanks; ++r) {" in body
    assert "oc += part_acc[r][tid] * w;" in body
    assert body.count("barrier.cluster.arrive.relaxed.aligned") == 1
    assert body.count("barrier.cluster.wait.aligned") == 1
    uses = sorted(ln.strip() for ln in body.splitlines() if "a.BS" in ln)
    assert uses == sorted([
        "const int reach = a.MAXB * a.BS;",
        "const int u = (rank + kRanks * ln) * kChunk / a.BS;",
        "if (wb >= a.NB || wo < 0 || wo >= a.BS) wb = -1;",
        "ent = kk < mine ? tab[(rank + kRanks * kk) * kChunk / a.BS] : 0;",
        "const int64_t off = (c * kChunk) % a.BS;",
        "const int u = t / a.BS;",
        "const int64_t off = t - u * a.BS;"])
    assert "atomic" not in code


def test_kernel_copies_chunks_in_bulk_before_any_math():
    """A chunk whose 16 rows are one run of the slab is one bulk copy for
    K and one for V on the slot's mbarrier, and other block sizes take
    16-byte cp.async completing on the same mbarrier, both with an L2
    evict-first policy; a block issues its first chunks before the loop
    that does the math. Over an int8 cache the ring is the same one slot
    (the study measured deeper int8 rings no faster), a chunk of 16 int8
    rows of 128 (K and V) 4 KiB of it, and a rank issues its first chunks,
    up to the ring's depth, before any math."""
    code, body = _kernel_code()
    header = (SRC.parent / "sm90.cuh").read_text()
    assert '#include "sm90.cuh"' in code
    assert "constexpr int kRing = 1;" in code and "kRingI8" not in code
    assert "static constexpr int kChunkBytes = kChunk * D * " \
        "static_cast<int>(sizeof(C));" in code
    assert "static constexpr int kRingSlots =\n      kSmemCap / kSlotBytes" \
        " < kRing ? kSmemCap / kSlotBytes : kRing;" in code
    assert "const int first = mine < nring ? mine : nring;" in body
    assert "constexpr int nring = L::kRingSlots;" in body
    assert "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx" \
        "::bytes.L2::cache_hint" in header
    assert "cp.async.mbarrier.arrive.noinc" in code
    assert "a.bulk = a.BS % kChunk == 0 && a.skt == D && a.svt == D;" in code
    assert body.count("bulk_load(") == 2
    first = body.index("for (int k = 0; k < first; ++k) issue(k);")
    assert first < body.index("mbar_wait(")
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in code
    # the two bulk copies and cp_async16 under the evict-first policy
    assert body.count("evict_first())") == 2
    assert code.count("L2::cache_hint") == 1 and \
        "createpolicy.fractional.L2::evict_first" in code


# ----------------------------------------------------------------------
# the block pool (host code, copied)
class TestBlockPool:
    def test_alloc_release_cycle(self):
        p = BlockPool(5, 4)
        got = [p.alloc() for _ in range(4)]
        assert sorted(got) == [1, 2, 3, 4] and NULL_BLOCK not in got
        with pytest.raises(PoolExhaustedError):
            p.alloc()
        for b in got:
            p.release(b)
        assert p.free_count() == 4
        p.check_invariant(tables=[])

    def test_double_free_raises(self):
        p = BlockPool(3, 4)
        b = p.alloc()
        p.release(b)
        with pytest.raises(RuntimeError, match="twice"):
            p.release(b)

    def test_refcount_shared_block(self):
        p = BlockPool(3, 4)
        b = p.alloc()
        p.retain(b)
        p.release(b)
        assert p.held_count() == 1
        p.release(b)
        assert p.held_count() == 0

    def test_prefix_register_lookup_evict_lru(self):
        p = BlockPool(4, 2)
        toks = np.arange(6, dtype=np.int32)
        hs = prefix_block_hashes(toks, 2)
        blocks = [p.alloc() for _ in range(3)]
        for h, b in zip(hs, blocks):
            assert p.register(h, b)
        for b in blocks:
            p.release(b)
        assert p.usable_free_count() == 3 and p.free_count() == 0
        assert p.lookup(hs, max_blocks=2) == blocks[:2]
        x = p.alloc()                       # evicts the LRU evictable
        assert x == blocks[2] and p.evictions == 1
        p.check_invariant(tables=[blocks[:2], [x]])

    def test_chain_hashes_depend_on_prefix(self):
        a = prefix_block_hashes(np.array([1, 2, 3, 4]), 2)
        b = prefix_block_hashes(np.array([9, 2, 3, 4]), 2)
        assert a[1] != b[1] and len(a) == 2
        assert prefix_block_hashes(np.array([1, 2, 3]), 2) == a[:1]

    def test_flush_and_reset(self):
        p = BlockPool(4, 2)
        b = p.alloc()
        p.register(prefix_block_hashes(np.array([1, 2]), 2)[0], b)
        assert p.flush_cache() == 1 and p.cached_count() == 0
        p.release(b)
        assert p.free_count() == 3
        p.alloc()
        p.reset()
        assert p.stats()["held"] == 0 and p.free_count() == 3

    def test_invariant_catches_seeded_leak(self):
        p = BlockPool(4, 2)
        p.alloc()
        p._free.pop()
        with pytest.raises(AssertionError, match="leak"):
            p.check_invariant()

    def test_blocks_for_tokens(self):
        assert [blocks_for_tokens(n, 8) for n in (0, 1, 8, 9, 16)] == \
            [0, 1, 1, 2, 2]


# ----------------------------------------------------------------------
# the server
def test_server_greedy_tokens_match_jax_greedy_decode(jsd, spec):
    jspec = jgpt.gpt_generative_spec(jsd, JCFG)
    prompts = mixed_prompts(6, seed=2)
    with make_server(spec, num_blocks=64) as srv:
        got = [h.result(timeout=60) for h in
               [srv.submit(p, max_new_tokens=8) for p in prompts]]
    want = [jax_greedy_decode(jspec, p, 8, max_seq_len=MSL) for p in prompts]
    assert got == want


def test_table_growth_across_buckets_equals_dense(spec, dense_spec):
    """Prompts in every pow2 prefill bucket, each decoding across a block
    boundary: the same tokens as the dense reference, bit for bit."""
    prompts = [np.arange(L, dtype=np.int32) % PCFG.vocab_size
               for L in (1, 2, 5, 9, 17)]
    with make_server(spec, num_blocks=64) as srv:
        got = [h.result(timeout=60) for h in
               [srv.submit(p, max_new_tokens=10) for p in prompts]]
    assert got == [ref_tokens(dense_spec, p, 10) for p in prompts]


def test_pool_drains_clean_after_traffic(spec):
    srv = make_server(spec, num_blocks=64)
    hs = [srv.submit(p, max_new_tokens=6) for p in mixed_prompts(8)]
    for h in hs:
        h.result(timeout=60)
    srv.shutdown()
    assert srv.pool.stats()["held"] == 0
    assert wait_uncommitted(srv) == 0
    srv.pool.check_invariant(tables=[])


def test_prefix_hit_matches_cold_and_runs_the_suffix_bucket(spec,
                                                            dense_spec):
    prompt = (np.arange(17, dtype=np.int32) * 3) % PCFG.vocab_size
    with make_server(spec) as srv:
        a = srv.submit(prompt, max_new_tokens=6).result(timeout=60)
        before = set(srv._shapes_seen)
        b = srv.submit(prompt, max_new_tokens=6).result(timeout=60)
        new = srv._shapes_seen - before
    assert a == b == ref_tokens(dense_spec, prompt, 6)
    rec = srv.metrics.to_record()["paged"]
    assert rec["prefix_blocks_hit"] == 2 and rec["prefix_hit_rate"] > 0
    # 17 tokens cold run bucket 32; the repeat prefills its 1-token suffix
    assert {dict(sig)["tokens"][0] for sig in new
            if "hist" in dict(sig)} == {1}


def test_update_model_flushes_prefix_cache(spec, dense_spec, psd):
    prompt = (np.arange(17, dtype=np.int32) * 3) % PCFG.vocab_size
    with make_server(spec) as srv:
        srv.submit(prompt, max_new_tokens=4).result(timeout=60)
        assert srv.pool.cached_count() > 0
        old = psd.get_arr_for_var("wte")
        try:
            psd.set_arr_for_var("wte", old + 0.5)
            srv.update_model()
            after = srv.submit(prompt, max_new_tokens=4).result(timeout=60)
            want = ref_tokens(dense_spec, prompt, 4)
        finally:
            psd.set_arr_for_var("wte", old)
            srv.update_model()
    assert after == want
    assert srv.metrics.to_record()["paged"]["prefix_blocks_hit"] == 0
    assert srv.metrics.counters["prefix_cache_flushes"] >= 1


def test_disabled_cache_never_hits(spec):
    prompt = (np.arange(17, dtype=np.int32) * 3) % PCFG.vocab_size
    with make_server(spec, prefix_cache=False) as srv:
        srv.submit(prompt, max_new_tokens=2).result(timeout=60)
        srv.submit(prompt, max_new_tokens=2).result(timeout=60)
    rec = srv.metrics.to_record()["paged"]
    assert rec["prefix_hit_rate"] == 0.0 and rec["cached_blocks"] == 0


def test_nan_poisoned_blocks_do_not_bleed_into_the_next_user(spec,
                                                             dense_spec):
    """Retire a generation, fill the WHOLE slab (the null block, the
    retired blocks, the free ones) with NaN, serve a new request: its
    tokens equal a fresh server's and the reference's."""
    p2 = np.array([11, 3, 7, 60, 2, 9, 9, 41, 5, 1], np.int32)
    with make_server(spec, max_slots=2) as srv:
        srv.generate(np.arange(1, 12, dtype=np.int32), max_new_tokens=9)
        time.sleep(0.05)
        with srv._exec_lock, torch.inference_mode():
            srv._kc.fill_(float("nan"))
            srv._vc.fill_(float("nan"))
        got = srv.generate(p2, max_new_tokens=12)
    with make_server(spec, max_slots=2) as fresh:
        want = fresh.generate(p2, max_new_tokens=12)
    assert got == want == ref_tokens(dense_spec, p2, 12)


def test_exhaustion_sheds_typed_and_retry_succeeds(spec):
    srv = make_server(spec, max_slots=4, num_blocks=9, start=False)
    try:
        p = np.arange(12, dtype=np.int32)
        h1 = srv.submit(p, max_new_tokens=8)
        h2 = srv.submit(p + 1, max_new_tokens=8)
        with pytest.raises(PoolExhaustedError) as ei:
            srv.submit(p + 2, max_new_tokens=8)
        assert ei.value.retry_after_s > 0
        # permanent errors stay permanent under pressure
        with pytest.raises(ValueError):
            srv.submit(np.asarray([PCFG.vocab_size], np.int32), 4)
        assert srv._committed == 6
        srv.start()
        assert h1.result(timeout=60) and h2.result(timeout=60)
        assert wait_uncommitted(srv) == 0
        assert srv.submit(p + 2, max_new_tokens=8).result(timeout=60)
    finally:
        srv.shutdown()
    assert srv.metrics.counters["requests_shed"] >= 1


def test_failed_submit_rolls_back_commitment(spec):
    with make_server(spec, max_slots=4, num_blocks=9) as srv:
        with pytest.raises(ValueError):
            srv.submit(np.asarray([999]), max_new_tokens=4)
        assert srv._committed == 0


def test_cancel_and_deadline_release_blocks_once(spec):
    with make_server(spec) as srv:
        h = srv.submit(np.arange(9, dtype=np.int32), max_new_tokens=20,
                       on_token=lambda t: time.sleep(0.01))
        next(iter(h.tokens(timeout=30)))
        h.cancel()
        h.result(timeout=30)
        h = srv.submit(np.arange(6, dtype=np.int32), max_new_tokens=20,
                       timeout_ms=30.0, on_token=lambda t: time.sleep(0.01))
        try:
            h.result(timeout=60)
        except Exception:
            pass
    assert srv.pool.stats()["held"] == 0
    assert wait_uncommitted(srv) == 0
    srv.pool.check_invariant(tables=[])


@pytest.mark.chaos
def test_crash_requeue_releases_blocks_exactly_once(spec, dense_spec):
    prompts = mixed_prompts(4, seed=7)
    srv = make_server(spec, start=False, resilience=ResilienceConfig(
        worker_backoff_base_s=0.01, worker_backoff_max_s=0.05))
    real = srv._decode_disp
    state = {"calls": 0, "fired": False}

    def crash_once(*args):
        state["calls"] += 1
        if not state["fired"] and state["calls"] > 2:
            state["fired"] = True
            raise RuntimeError("chaos: decode worker dies")
        return real(*args)

    srv._decode_disp = crash_once
    try:
        srv.start()
        got = [h.result(timeout=120) for h in
               [srv.submit(p, max_new_tokens=8) for p in prompts]]
    finally:
        srv.shutdown()
    assert state["fired"]
    assert got == [ref_tokens(dense_spec, p, 8) for p in prompts]
    assert srv.metrics.counters["worker_restarts"] >= 1
    assert srv.metrics.counters["requests_requeued"] >= 1
    assert srv.pool.stats()["held"] == 0
    assert wait_uncommitted(srv) == 0


def test_warmup_runs_every_shape_once_then_traffic_adds_none(psd):
    spec = pgpt.gpt_paged_spec(psd, PCFG)
    with make_server(spec, warmup=True, num_blocks=64) as srv:
        assert srv.warmup_report["prefill_buckets"] == [1, 2, 4, 8, 16, 32]
        assert srv.metrics.counters["warmup_compiles"] == 7
        assert srv.warmup_report["kernel_builds"] == []     # CPU: none
        for i, p in enumerate(mixed_prompts(6, seed=3, max_len=20)):
            srv.generate(p, max_new_tokens=3 + i % 4)
        assert srv.metrics.counters["compiles"] == 0


def test_not_ported_options_raise(psd, spec):
    """Tensor-parallel serving is refused by name; int8 KV, refused here
    until it was ported, now serves: an int8 pool whose tokens equal the
    dense int8 server's over the same scales (tests/test_torch_int8kv.py
    holds it to the JAX package)."""
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        make_server(spec, tp=2)
    qspec = pgpt.gpt_paged_spec(psd, PCFG, quantize_kv=True)
    assert qspec.kv_dtype == "int8"
    dense = pgpt.gpt_generative_spec(psd, PCFG, quantize_kv=True)
    prompt = np.arange(1, 6, dtype=np.int32)
    with make_server(qspec) as srv:
        assert srv._kc.dtype == torch.int8
        got = srv.submit(prompt, max_new_tokens=5).result(timeout=60)
    assert len(got) == 5
    pgpt.gpt_paged_decode_fns(PCFG, BS, MAXB, kv_scales={
        "k": np.ones((2, 2, 16), np.float32),
        "v": np.ones((2, 2, 16), np.float32)})
    assert dense.kv_dtype == "int8"


def test_metrics_cold_start_and_block_accounting(spec):
    rec = PagedMetrics(4, 16, 8).to_record()["paged"]
    assert all(np.isfinite(v) for v in rec.values())
    assert rec["pool_occupancy"] == 0.0
    with make_server(spec, num_blocks=17) as srv:
        srv.generate(np.arange(10, dtype=np.int32), max_new_tokens=3)
    assert srv.pool.capacity == 16
    assert tuple(srv._kc.shape) == (2, 17, 2, 8, 16)
    assert srv.bytes_per_block == 2 * 2 * 2 * 8 * 16 * 4
    assert srv.metrics.to_record()["paged"]["blocks_per_request"] == 2


# ----------------------------------------------------------------------
# the case builders chip_smoke.py and the card tests check the kernel with
def test_case_builders_poison_and_dense_keep_the_plain_version():
    from deeplearning4j_tpu_torch.kernels import measure
    cpu = torch.device("cpu")
    for args in (measure.paged_decode_case(cpu, [0, 7, 8, 19], 2, 16, 8,
                                           torch.float64, seed=1),
                 measure.paged_prefill_case(cpu, 16, 8, 5, 2, 16, 8,
                                            torch.float64, seed=2)):
        q, kc, vc, tables, lane, kmax = args
        out = pa.paged_attention(*args)
        pk, pv = measure.paged_poisoned(kc, vc, tables, lane, kmax)
        assert torch.isnan(pk).any()
        assert torch.equal(pa.paged_attention(q, pk, pv, tables, lane, kmax),
                           out)
        terms = pa.abs_terms(*args)
        assert measure.paged_reading(out, out, terms, 1e-12) == 0.0
        # the controls the chip run must see fail: a mask off by one, a
        # table entry one block off
        off = pa.paged_attention_plain(q, kc, vc, tables, lane, kmax - 1)
        assert measure.paged_reading(off, out, terms, 1e-5) > 1
        shifted = tables.clone()
        shifted[:, 0] += 1
        moved = pa.paged_attention_plain(q, kc, vc, shifted, lane, kmax)
        assert measure.paged_reading(moved, out, terms, 1e-5) > 1
    q, kc, vc, tables, lane, kmax = measure.paged_decode_case(
        cpu, [0, 7, 8, 19], 2, 16, 8, torch.float64, seed=1)
    dk, dv, dt = measure.paged_dense(kc, vc, tables)
    assert dk.shape == (4, 2, 24, 16) and dt.tolist() == [[0], [1], [2],
                                                          [3]]
    _close(pa.paged_attention(q, dk, dv, dt, lane, kmax),
           pa.paged_attention(q, kc, vc, tables, lane, kmax).numpy(), 1e-12)
    flops, nbytes = measure.paged_bounds(q, kc, tables, lane, kmax)
    assert flops == 4 * 16 * 2 * (1 + 8 + 9 + 20)
    assert nbytes == (1 + 8 + 9 + 20) * 2 * 16 * 8 * 2 + 2 * 4 * 2 * 16 * 8
