"""The port's int8 KV cache (``zoo/gpt.py``'s ``kv_scales``,
``gpt_kv_scales`` and ``quantize_kv`` specs, the int8 plain versions of
``kernels/paged_attention.py``, ``PagedGenerativeServer(kv_hbm_bytes=)``
and ``serving/loadgen.py``) against the JAX package, on the CPU.

GPT_TINY (vocab 256, hidden 64, 2 layers, 4 heads of 16, max_seq 64) from
the JAX package's ``build_gpt(seed=0)``, float32 on both sides through
``convert.samediff_arrays_from_jax``, and the JAX package's
``gpt_kv_scales`` handed to both sides' decode functions.

Tolerances: the stored int8 rows equal JAX's except where the two sides'
float32 K/V (matmuls summed in another order) fall on the two sides of a
rounding tie: at most 0.1% of the entries, each off by exactly 1; logits
within 1e-4 absolute (the dequantised context of one such entry moves a
logit by about a scale's worth of one channel, and with x64 on the JAX
softmax runs in float64); greedy tokens equal. ``q_store`` equals the JAX
``_q_store`` expression bit for bit, ties included. ``gpt_kv_scales``
equals JAX's within one quantile bin (1/512 of the channel's absmax) per
channel: the binned quantile moves by a bin when a float32 observation
differs in its last bits.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.serving.generative import \
    greedy_decode as jax_greedy_decode
from deeplearning4j_tpu.serving.loadgen import \
    GenerativeLoadGenerator as JaxLoadGenerator
from deeplearning4j_tpu.zoo import gpt as jgpt
from deeplearning4j_tpu_torch.convert import samediff_arrays_from_jax
from deeplearning4j_tpu_torch.kernels import paged_attention as pa
from deeplearning4j_tpu_torch.serving import (GenerativeServer,
                                              greedy_decode)
from deeplearning4j_tpu_torch.serving.loadgen import (
    GenerativeLoadGenerator, LoadResult)
from deeplearning4j_tpu_torch.serving.paged import PagedGenerativeServer
from deeplearning4j_tpu_torch.zoo import gpt as pgpt

JCFG, PCFG = jgpt.GPT_TINY, pgpt.GPT_TINY
L, A, D, MSL = 2, 4, 16, 64
BS = 8
MAXB = MSL // BS


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
def scales(jsd):
    return jgpt.gpt_kv_scales(jsd, JCFG)


def _params(jsd, psd):
    names = jgpt.gpt_param_names(JCFG)
    return ({n: jsd._arrays[n] for n in names},
            {n: psd.get_arr_for_var(n) for n in names})


def _slabs_equal(got, want, frac=1e-3):
    """int8 slabs equal but for at most ``frac`` of entries off by 1."""
    got = got.numpy().astype(np.int32) if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.int32)
    diff = np.abs(got - np.asarray(want, np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() <= frac, (diff > 0).mean()


def _logits_close(got, want, atol=1e-4):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    err = float(np.max(np.abs(got - np.asarray(want, np.float64))))
    assert err <= atol, err


# ----------------------------------------------------------------------
# the store
def _jax_q_store(x, s):
    """zoo/gpt.py ``_q_store`` (:294-298, :576-579) on an int8 slab."""
    return np.asarray(jnp.clip(jnp.round(jnp.asarray(x) / jnp.asarray(s)),
                               -127, 127).astype(jnp.int8))


def test_q_store_equals_jax_at_ties_and_clips():
    s = np.full(12, 0.5, np.float32)       # x / s exact: the ties are ties
    ties = np.array([2.5, -2.5, 127.5, -127.5, 200.0, -200.0, 0.5, -0.5,
                     1.5, -1.5, 126.5, 3.5], np.float32)
    x = ties * s
    got = pa.q_store(torch.from_numpy(x), torch.from_numpy(s)).numpy()
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, _jax_q_store(x, s))
    np.testing.assert_array_equal(
        got, [2, -2, 127, -127, 127, -127, 0, 0, 2, -2, 126, 4])


@pytest.mark.parametrize("seed", [0, 1])
def test_q_store_equals_jax_on_random_rows(seed):
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.005, 0.05, size=(A, D)).astype(np.float32)
    x = (rng.standard_normal((33, A, D)) * 2).astype(np.float32)
    got = pa.q_store(torch.from_numpy(x), torch.from_numpy(s)).numpy()
    np.testing.assert_array_equal(got, _jax_q_store(x, s))
    # a float64 row divides in float64, as torch and numpy do
    x64 = x.astype(np.float64)
    np.testing.assert_array_equal(
        pa.q_store(torch.from_numpy(x64), torch.from_numpy(s)).numpy(),
        np.clip(np.round(x64 / s), -127, 127).astype(np.int8))


def test_q_load_rounds_in_float32_then_widens():
    x = torch.tensor([[-127, 3, 0, 101]], dtype=torch.int8)
    s = torch.tensor([0.013, 0.7, 1.1, 0.0077], dtype=torch.float32)
    want = (x.numpy().astype(np.float32) * s.numpy()).astype(np.float64)
    got = pa.q_load(x, s, torch.float64)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)
    assert pa.q_load(x, None, torch.float64) is x


# ----------------------------------------------------------------------
# the dense decode functions
def _dense_run(jsd, psd, scales, verify_w=4):
    """Prefill a prompt into slot 1 of 3, 8 greedy decode steps (every
    slot active, each side fed its own tokens), then a verify window:
    JAX's and the port's outputs and slabs at each stage."""
    jfns = jgpt.gpt_decode_fns(JCFG, kv_scales=scales)
    pfns = pgpt.gpt_decode_fns(PCFG, kv_scales=scales)
    jp, pp = _params(jsd, psd)
    rng = np.random.default_rng(7)
    shape = (L, 3, A, MSL, D)
    init = [rng.integers(-127, 128, size=shape).astype(np.int8)
            for _ in range(2)]
    j = [jnp.asarray(a) for a in init]
    p = [torch.from_numpy(a.copy()) for a in init]
    prompt = np.array([5, 17, 40, 2, 33, 201, 90], np.int32)
    io = {"tokens": np.pad(prompt, (0, 1)), "length": np.int32(7),
          "slot": np.int32(1)}
    stages = []
    jkc, jvc, jn, jl = jfns[0](jp, *j, io)
    with torch.inference_mode():
        pkc, pvc, pn, pl = pfns[0](pp, *p, io)
    stages.append(("prefill", (jkc, jvc, jn, jl),
                   (pkc.clone(), pvc.clone(), pn, pl)))
    tok_j, tok_p = np.array([3, int(jn), 9], np.int32), \
        np.array([3, int(pn), 9], np.int32)
    pos = np.array([20, 7, 40], np.int32)
    for _ in range(8):
        act = np.array([True, True, True])
        jkc, jvc, jn, jl = jfns[1](jp, jkc, jvc, {
            "tokens": tok_j, "positions": pos, "active": act})
        with torch.inference_mode():
            pkc, pvc, pn, pl = pfns[1](pp, pkc, pvc, {
                "tokens": tok_p, "positions": pos, "active": act})
        stages.append(("decode", (jkc, jvc, jn, jl),
                       (pkc.clone(), pvc.clone(), pn, pl)))
        tok_j, tok_p = np.asarray(jn), pn.numpy()
        pos = pos + 1
    window = np.stack([tok_j] + [(tok_j + k) % 256 for k in
                                 range(1, verify_w)], axis=1).astype(np.int32)
    vio = {"tokens": window, "positions": pos,
           "active": np.array([True, False, True])}
    jkc, jvc, jn, jl = jfns[2](jp, jkc, jvc, vio)
    with torch.inference_mode():
        pkc, pvc, pn, pl = pfns[2](pp, pkc, pvc, vio)
    stages.append(("verify", (jkc, jvc, jn, jl), (pkc, pvc, pn, pl)))
    return stages


def test_dense_int8_prefill_decode_verify_match_jax(jsd, psd, scales):
    stages = _dense_run(jsd, psd, scales)
    for name, (jkc, jvc, jn, jl), (pkc, pvc, pn, pl) in stages:
        assert pkc.dtype == torch.int8 and pvc.dtype == torch.int8
        _slabs_equal(pkc, jkc)
        _slabs_equal(pvc, jvc)
        if name == "verify":        # the inactive lane's rows are unused
            act = np.array([0, 2])
            _logits_close(pl[act], np.asarray(jl)[act])
            np.testing.assert_array_equal(pn.numpy()[act],
                                          np.asarray(jn)[act])
        else:
            _logits_close(pl, jl)
            np.testing.assert_array_equal(np.asarray(pn), np.asarray(jn))


def test_dense_prefill_attends_over_fresh_rows_and_decode_over_stored():
    """The prefill's attention reads its float k and v (only its slab
    write is quantised); a decode step reads back its own row stored:
    with every scale huge, the stored rows are all 0, so the prefill's
    logits are the float prefill's and a decode step's are not."""
    sd = pgpt.build_gpt(PCFG, batch=1, seq_len=8, seed=1, device="cpu")
    names = pgpt.gpt_param_names(PCFG)
    pp = {n: sd.get_arr_for_var(n) for n in names}
    huge = {"k": np.full((L, A, D), 1e6, np.float32),
            "v": np.full((L, A, D), 1e6, np.float32)}
    f32 = pgpt.gpt_decode_fns(PCFG)
    i8 = pgpt.gpt_decode_fns(PCFG, kv_scales=huge)
    io = {"tokens": np.array([4, 8, 15, 16], np.int32),
          "length": np.int32(4), "slot": np.int32(0)}
    with torch.inference_mode():
        fk, fv = (torch.zeros(L, 1, A, MSL, D) for _ in range(2))
        qk, qv = (torch.zeros(L, 1, A, MSL, D, dtype=torch.int8)
                  for _ in range(2))
        *_, fl = f32[0](pp, fk, fv, io)
        *_, ql = i8[0](pp, qk, qv, io)
        assert torch.equal(fl, ql) and not qk.any()
        dio = {"tokens": np.array([23], np.int32),
               "positions": np.array([4], np.int32),
               "active": np.array([True])}
        *_, fl = f32[1](pp, fk, fv, dio)
        *_, ql = i8[1](pp, qk, qv, dio)
        assert not torch.allclose(fl, ql)


# ----------------------------------------------------------------------
# the paged decode functions
def _paged_run(jsd, psd, scales):
    """A cold prefill and a prefix hit, 8 decode steps of two lanes, then
    a verify window of 5: JAX's and the port's at each stage."""
    jfns = jgpt.gpt_paged_decode_fns(JCFG, BS, MAXB, kv_scales=scales)
    pfns = pgpt.gpt_paged_decode_fns(PCFG, BS, MAXB, kv_scales=scales)
    jp, pp = _params(jsd, psd)
    rng = np.random.default_rng(8)
    shape = (L, 24, A, BS, D)
    init = [rng.integers(-127, 128, size=shape).astype(np.int8)
            for _ in range(2)]
    j = [jnp.asarray(a) for a in init]
    p = [torch.from_numpy(a.copy()) for a in init]
    stages = []

    def run(fn, io, pio=None):
        """JAX fed ``io``, the port ``pio`` (``io`` where None)."""
        jkc, jvc, jn, jl = jfns[fn](jp, *j, io)
        with torch.inference_mode():
            out = pfns[fn](pp, *p, io if pio is None else pio)
        assert out[0] is p[0] and out[1] is p[1]          # in place
        j[:] = [jkc, jvc]
        stages.append((("prefill", "decode", "verify")[fn],
                       (jkc, jvc, jn, jl),
                       (out[0].clone(), out[1].clone(), *out[2:])))
        return np.asarray(jn), out[2].numpy()

    prompt = (np.arange(13, dtype=np.int32) * 37) % 256
    t1 = np.array([3, 7, 0, 0, 0, 0, 0, 0], np.int32)
    run(0, {"tokens": np.pad(prompt, (0, 3)), "length": np.int32(13),
            "hist": np.int32(0), "table": t1})
    longer = np.concatenate([prompt[:8], np.arange(11, dtype=np.int32)])
    t2 = np.array([3, 9, 10, 0, 0, 0, 0, 0], np.int32)
    run(0, {"tokens": np.pad(longer[8:], (0, 5)), "length": np.int32(11),
            "hist": np.int32(8), "table": t2})
    tables = np.stack([np.array([3, 7, 11, 12, 0, 0, 0, 0], np.int32),
                       np.array([3, 9, 10, 13, 14, 0, 0, 0], np.int32)])
    pos = np.array([13, 19], np.int32)
    tok_j = tok_p = np.array([1, 2], np.int32)
    for _ in range(8):
        io = {"positions": pos, "active": np.array([True, True]),
              "tables": tables,
              "write_block": tables[np.arange(2), pos // BS],
              "write_off": (pos % BS).astype(np.int32)}
        tok_j, tok_p = run(1, {**io, "tokens": tok_j},
                           {**io, "tokens": tok_p})
        pos = pos + 1
    W = 5
    at = pos[:, None] + np.arange(W)[None, :]
    run(2, {"tokens": (tok_j[:, None] + np.arange(W)[None, :]).astype(
        np.int32) % 256, "positions": pos, "active": np.array([True, True]),
        "tables": tables,
        "write_block": tables[np.arange(2)[:, None], at // BS],
        "write_off": (at % BS).astype(np.int32)})
    return stages


def test_paged_int8_prefill_decode_verify_match_jax(jsd, psd, scales):
    stages = _paged_run(jsd, psd, scales)
    for name, (jkc, jvc, jn, jl), (pkc, pvc, pn, pl) in stages:
        assert pkc.dtype == torch.int8
        # every block but the null one (where JAX writes padded rows)
        _slabs_equal(pkc[:, 1:], np.asarray(jkc)[:, 1:])
        _slabs_equal(pvc[:, 1:], np.asarray(jvc)[:, 1:])
        _logits_close(pl, jl)
        np.testing.assert_array_equal(np.asarray(pn), np.asarray(jn))


def test_paged_int8_decode_is_one_int8_launch_a_layer(monkeypatch, psd,
                                                      scales):
    """With the card's launch stubbed, each decode step calls the kernel
    once a layer with the int8 slab and that layer's scales."""
    import types
    seen = []
    monkeypatch.setattr(pa, "_check", lambda q, *a: types.SimpleNamespace(
        type="cuda"))
    monkeypatch.setattr(pa, "_check_write", lambda *a: None)
    monkeypatch.setattr(pa, "_launch", lambda q, kc, vc, *a, scales=None,
                        **kw: seen.append((kc.dtype, scales))
                        or torch.zeros_like(q))
    pfns = pgpt.gpt_paged_decode_fns(PCFG, BS, MAXB, kv_scales=scales)
    pp = {n: psd.get_arr_for_var(n) for n in pgpt.gpt_param_names(PCFG)}
    kc, vc = (torch.zeros(L, 6, A, BS, D, dtype=torch.int8) for _ in range(2))
    io = {"tokens": np.array([1], np.int32),
          "positions": np.array([3], np.int32),
          "active": np.array([True]), "tables": np.array([[1] + [0] * 7],
                                                         np.int32),
          "write_block": np.array([1], np.int32),
          "write_off": np.array([3], np.int32)}
    with torch.inference_mode():
        pfns[1](pp, kc, vc, io)
    assert len(seen) == L
    for i, (dt, sc) in enumerate(seen):
        assert dt == torch.int8
        np.testing.assert_array_equal(sc[0].numpy(), scales["k"][i])
        np.testing.assert_array_equal(sc[1].numpy(), scales["v"][i])


def test_paged_int8_prefill_is_one_int8_launch_a_layer(monkeypatch, psd,
                                                       scales):
    """With the card's launch stubbed, each prefill calls the float32
    prefill entry once a layer with the int8 slab and that layer's scales,
    its work split sized by the int8 kernel's blocks an SM (``slots``'
    paged 2), each call counted as an int8 one."""
    import contextlib
    import types
    from deeplearning4j_tpu_torch.kernels import attention_f32 as af
    seen, sized = [], []
    monkeypatch.setattr(pa, "_check", lambda q, *a: types.SimpleNamespace(
        type="cuda"))
    monkeypatch.setattr(af, "slots", lambda index, d, kind: sized.append(
        kind) or 264)
    monkeypatch.setattr(af, "_stream", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(af, "launch_prefill", lambda q, kc, vc, table, kmax,
                        out, part, scale, chunk, stream, k_scale=None,
                        v_scale=None, lib=None: seen.append(
                            (kc.dtype, k_scale, v_scale, chunk)))
    pfns = pgpt.gpt_paged_decode_fns(PCFG, BS, MAXB, kv_scales=scales)
    pp = {n: psd.get_arr_for_var(n) for n in pgpt.gpt_param_names(PCFG)}
    kc, vc = (torch.zeros(L, 6, A, BS, D, dtype=torch.int8) for _ in range(2))
    io = {"tokens": np.arange(1, 12, dtype=np.int32),
          "length": np.int32(11), "hist": np.int32(0),
          "table": np.array([1, 2] + [0] * (MAXB - 2), np.int32)}
    af.reset_launches()
    with torch.inference_mode():
        pfns[0](pp, kc, vc, io)
    assert len(seen) == L and sized == ["paged_i8"] * L
    assert af.INT8_LAUNCHES["paged_prefill_f32"] == L
    for i, (dt, ks, vs, chunk) in enumerate(seen):
        assert dt == torch.int8 and chunk % af.CHUNK_ALIGN == 0
        np.testing.assert_array_equal(ks.numpy(), scales["k"][i])
        np.testing.assert_array_equal(vs.numpy(), scales["v"][i])


# ----------------------------------------------------------------------
# the int8 plain versions against float caches holding the dequantised
# values (each row a call writes read back stored)
def _int8_case(seed, nb=10, bs=8, rows=3):
    rng = np.random.default_rng(seed)
    ks, vs = (torch.from_numpy(rng.uniform(0.01, 0.05, (A, D)).astype(
        np.float32)) for _ in range(2))
    kc, vc = (torch.from_numpy(rng.integers(-127, 128, (nb, A, bs, D))
                               .astype(np.int8)) for _ in range(2))
    q, kn, vn = (torch.from_numpy(rng.standard_normal((rows, A, D)).astype(
        np.float32)) for _ in range(3))
    return q, kn, vn, kc, vc, ks, vs


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_int8_decode_plain_is_the_float_plain_of_the_stored_rows(dtype):
    q, kn, vn, kc, vc, ks, vs = _int8_case(0)
    q, kn, vn = (t.to(dtype) for t in (q, kn, vn))
    tables = torch.tensor([[1, 2, 3], [4, 5, 0], [6, 0, 0]],
                          dtype=torch.int32)
    lane = torch.arange(3, dtype=torch.int32)
    kmax = torch.tensor([20, 9, 0], dtype=torch.int32)
    wb = torch.tensor([3, 5, 6], dtype=torch.int32)
    wo = torch.tensor([4, 1, 0], dtype=torch.int32)
    k8, v8 = kc.clone(), vc.clone()
    got = pa.paged_decode_attention(q, kn, vn, k8, v8, tables, lane, kmax,
                                    wb, wo, ks, vs)
    assert got.dtype == dtype
    for r in range(3):
        np.testing.assert_array_equal(
            k8[wb[r], :, wo[r]].numpy(), pa.q_store(kn[r], ks).numpy())
    kf = pa.q_load(k8, ks[:, None, :], dtype)
    vf = pa.q_load(v8, vs[:, None, :], dtype)
    want = pa.paged_attention_plain(q, kf, vf, tables, lane, kmax)
    assert torch.equal(got, want)


def test_int8_verify_and_prefill_plain_read_their_rows_stored():
    q, kn, vn, kc, vc, ks, vs = _int8_case(1, rows=4)
    tables = torch.tensor([[1, 2, 3]], dtype=torch.int32)
    lane = torch.zeros(4, dtype=torch.int32)
    kmax = torch.tensor([10, 11, 12, 13], dtype=torch.int32)
    win0 = torch.full((4,), 10, dtype=torch.int32)
    wrow = torch.zeros(4, dtype=torch.int32)
    wb = torch.tensor([2, 2, 2, 2], dtype=torch.int32)
    wo = torch.tensor([2, 3, 4, 5], dtype=torch.int32)
    k8, v8 = kc.clone(), vc.clone()
    got = pa.paged_verify_attention(q, kn, vn, k8, v8, tables, lane, kmax,
                                    win0, wrow, wb, wo, ks, vs)
    # the same as the decode of each row after the window's writes
    k2, v2 = k8.clone(), v8.clone()
    for r in range(4):
        row = pa.paged_attention(q[r:r + 1], k2, v2, tables, lane[:1],
                                 kmax[r:r + 1], ks, vs)
        torch.testing.assert_close(got[r:r + 1], row, rtol=0, atol=1e-6)
    # the prefill's plain version over the stored slab
    pre = pa.paged_prefill_attention(q, k8, v8, tables[0], kmax,
                                     kmax.tolist(), ks, vs)
    kf, vf = pa.dequantized(k8, ks), pa.dequantized(v8, vs)
    assert torch.equal(pre, pa.paged_prefill_plain(q, kf, vf, tables[0],
                                                   kmax))


@pytest.mark.parametrize("bad,match", [
    (dict(k_scale=None), "go together"),
    (dict(kc=torch.zeros(4, 2, 8, 16)), "int8 cache"),
    (dict(k_scale=torch.zeros(2, 8)), r"\[A, D\]"),
    (dict(q=torch.zeros(2, 2, 16, dtype=torch.bfloat16)), "float32 or"),
])
def test_wrapper_refuses_a_bad_int8_cache(bad, match):
    args = dict(q=torch.zeros(2, 2, 16),
                kc=torch.zeros(4, 2, 8, 16, dtype=torch.int8),
                vc=torch.zeros(4, 2, 8, 16, dtype=torch.int8),
                tables=torch.zeros(2, 3, dtype=torch.int32),
                lane=torch.zeros(2, dtype=torch.int32),
                kmax=torch.zeros(2, dtype=torch.int32),
                k_scale=torch.ones(2, 16), v_scale=torch.ones(2, 16))
    args.update(bad)
    with pytest.raises(ValueError, match=match):
        pa.paged_attention(**args)


# ----------------------------------------------------------------------
# calibration, specs, servers
def test_gpt_kv_scales_match_jax_within_one_bin(jsd, psd, scales):
    got = pgpt.gpt_kv_scales(psd, PCFG)
    absmax = jgpt.gpt_kv_scales(jsd, JCFG, method="absmax")
    for n in ("k", "v"):
        assert got[n].shape == (L, A, D) and got[n].dtype == np.float32
        bin_ = absmax[n] / 512.0
        assert np.all(np.abs(got[n] - scales[n]) <= bin_ * 1.001 + 1e-9), \
            np.max(np.abs(got[n] - scales[n]) / bin_)
    np.testing.assert_allclose(pgpt.gpt_kv_scales(psd, PCFG,
                                                  method="absmax")["k"],
                               absmax["k"], rtol=1e-5)


def test_quantize_kv_specs_serve_int8_slabs(psd):
    """``quantize_kv=True`` on both specs (int8 weights too): int8 slabs
    whose bytes the servers count at one byte, the dense server's tokens
    equal ``greedy_decode`` of its spec, the paged server's with a
    self-draft equal the paged server's without one."""
    dspec = pgpt.gpt_generative_spec(psd, PCFG, quantize_weights=True,
                                     quantize_kv=True)
    pspec = pgpt.gpt_paged_spec(psd, PCFG, quantize_weights=True,
                                quantize_kv=True)
    assert dspec.kv_dtype == pspec.kv_dtype == "int8"
    draft = pgpt.gpt_generative_spec(
        psd, PCFG.__class__(**{**PCFG.__dict__, "num_layers": 1}),
        quantize_weights=True, quantize_kv=True)
    prompts = [np.array([5, 9, 2], np.int32),
               np.arange(1, 12, dtype=np.int32)]
    with GenerativeServer(dspec, max_slots=2, device="cpu") as srv:
        got = [srv.submit(p, max_new_tokens=6).result(timeout=60)
               for p in prompts]
        assert srv._kc.dtype == torch.int8
        assert srv.kv_slab_bytes == 2 * L * 2 * A * MSL * D
    assert got == [greedy_decode(dspec, p, 6, device="cpu") for p in prompts]
    kw = dict(max_slots=2, block_size=BS, device="cpu", debug_leaks=True)
    with PagedGenerativeServer(pspec, **kw) as srv:
        plain = [srv.submit(p, max_new_tokens=9).result(timeout=60)
                 for p in prompts]
    with PagedGenerativeServer(pspec, draft_spec=draft, speculate_k=4,
                               **kw) as srv:
        spec = [srv.submit(p, max_new_tokens=9).result(timeout=60)
                for p in prompts]
        assert srv.metrics.to_record()["generative"]["spec_rounds"] >= 1
        assert srv._dkc.dtype == torch.int8
    assert spec == plain


def test_int8_greedy_matches_jax_int8_greedy(jsd, psd, scales, monkeypatch):
    """The port's dense int8 spec, calibrated with JAX's scales, gives the
    JAX package's int8 greedy tokens."""
    monkeypatch.setattr(pgpt, "gpt_kv_scales", lambda *a, **kw: scales)
    pspec = pgpt.gpt_generative_spec(psd, PCFG, quantize_kv=True)
    jspec = jgpt.gpt_generative_spec(jsd, JCFG, quantize_kv=True)
    for prompt in (np.array([7, 1, 99], np.int32),
                   np.arange(3, 40, 3, dtype=np.int32)):
        assert greedy_decode(pspec, prompt, 8, device="cpu") == \
            list(jax_greedy_decode(jspec, prompt, 8))


def test_int8_kv_multiplies_pool_capacity_equal_bytes(psd):
    """tests/test_paged.py's bar: at one ``kv_hbm_bytes`` budget the int8
    pool holds at least 1.9x the float32 blocks (here 4x), and serves."""
    budget = 1 << 20
    kw = dict(max_slots=4, block_size=BS, device="cpu",
              kv_hbm_bytes=budget)
    f32 = PagedGenerativeServer(pgpt.gpt_paged_spec(psd, PCFG), **kw)
    q = PagedGenerativeServer(pgpt.gpt_paged_spec(
        psd, PCFG, quantize_weights=True, quantize_kv=True), **kw)
    try:
        nf = f32.metrics.to_record()["paged"]["num_blocks"]
        nq = q.metrics.to_record()["paged"]["num_blocks"]
        assert nq >= 1.9 * nf, (nq, nf)
        assert (nf + 1, nq + 1) == (budget // f32.bytes_per_block,
                                    budget // q.bytes_per_block)
        assert q.bytes_per_block * 4 == f32.bytes_per_block
        got = q.submit(np.asarray([5, 9, 2], np.int32),
                       max_new_tokens=6).result(timeout=120)
        assert len(got) == 6
    finally:
        f32.shutdown()
        q.shutdown()


def test_pool_sizing_options(psd):
    spec = pgpt.gpt_paged_spec(psd, PCFG)
    kw = dict(max_slots=2, block_size=BS, device="cpu")
    with PagedGenerativeServer(spec, kv_hbm_bytes=1, **kw) as srv:
        assert srv.pool.capacity == 1                 # max(2, ...) blocks
    with PagedGenerativeServer(spec, max_blocks_per_req=MAXB + 2,
                               **kw) as srv:
        assert srv._tables.shape == (2, MAXB + 2)
    with pytest.raises(ValueError, match="cannot hold max_seq_len"):
        PagedGenerativeServer(spec, max_blocks_per_req=MAXB - 1, **kw)


# ----------------------------------------------------------------------
# the load generator
@pytest.mark.parametrize("kw", [
    dict(seed=23, prompt_len=(2, 16), new_tokens=(4, 24)),
    dict(seed=5, prompt_len=(1, 40), new_tokens=(1, 9),
         deadline_ms=(50.0, 900.0), temperature=(0.0, 1.5))])
def test_loadgen_trace_is_jax_s(kw):
    port = GenerativeLoadGenerator(None, vocab_size=256, **kw)
    jax_ = JaxLoadGenerator(None, vocab_size=256, **kw)
    for i in range(24):
        got, want = port.request(i), jax_.request(i)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


@pytest.mark.parametrize("loop", ["closed", "open"])
def test_loadgen_drives_a_paged_int8_server(psd, loop):
    spec = pgpt.gpt_paged_spec(psd, PCFG, quantize_kv=True)
    with PagedGenerativeServer(spec, max_slots=4, block_size=BS,
                               device="cpu") as srv:
        lg = GenerativeLoadGenerator(srv, seed=23, prompt_len=(2, 16),
                                     new_tokens=(4, 12))
        res = lg.run_closed(8, concurrency=4) if loop == "closed" else \
            lg.run_open(8, rate_rps=200.0)
    budgets = [lg.request(i)[1] for i in range(8)]
    assert (res.n_ok, res.n_issued) == (8, 8)
    assert res.tokens_total == sum(budgets)
    assert len(res.ttft_ms) == 8
    assert len(res.intertoken_ms) == sum(budgets) - 8
    assert res.tokens_per_sec > 0 and res.ttft_percentile(99) > 0
    assert "tok/s" in res.stats()
    with pytest.raises(NotImplementedError, match="FleetLoadGenerator"):
        LoadResult().slo_attainment(100.0)


def test_int8_slab_bytes_equal_the_jax_servers(jsd, psd, scales,
                                               monkeypatch):
    """The dense server's int8 slabs and the draft's, and the paged pool's
    bytes a block, count as the JAX servers count them at int8."""
    from deeplearning4j_tpu.serving.generative import \
        GenerativeServer as JaxServer
    from deeplearning4j_tpu.serving.paged import \
        PagedGenerativeServer as JaxPaged
    monkeypatch.setattr(pgpt, "gpt_kv_scales", lambda *a, **kw: scales)
    dcfg = {**PCFG.__dict__, "num_layers": 1}
    pdraft = pgpt.gpt_generative_spec(psd, PCFG.__class__(**dcfg),
                                      quantize_kv=True)
    jdraft = jgpt.gpt_generative_spec(jsd, JCFG.__class__(**dcfg),
                                      quantize_kv=True)
    kw = dict(max_slots=3, max_seq_len=MSL, speculate_k=4, start=False)
    port = GenerativeServer(pgpt.gpt_generative_spec(psd, PCFG,
                                                     quantize_kv=True),
                            draft_spec=pdraft, device="cpu", **kw)
    jax_ = JaxServer(jgpt.gpt_generative_spec(jsd, JCFG, quantize_kv=True),
                     draft_spec=jdraft, warmup=False, **kw)
    pk = dict(max_slots=3, block_size=BS, max_seq_len=MSL, start=False,
              kv_hbm_bytes=1 << 18)
    pp = PagedGenerativeServer(pgpt.gpt_paged_spec(psd, PCFG,
                                                   quantize_kv=True),
                               device="cpu", **pk)
    jp = JaxPaged(jgpt.gpt_paged_spec(jsd, JCFG, quantize_kv=True),
                  warmup=False, **pk)
    try:
        assert (port.kv_slab_bytes, port.draft_slab_bytes) == (
            jax_.kv_slab_bytes, jax_.draft_slab_bytes)
        assert port._kc.dtype == port._dkc.dtype == torch.int8
        assert (pp.bytes_per_block, pp.kv_slab_bytes, pp.pool.capacity) == (
            jp.bytes_per_block, jp.kv_slab_bytes, jp.pool.capacity)
    finally:
        for s in (port, jax_, pp, jp):
            s.shutdown()
