"""The port's speculative decoding (the verify functions of ``zoo/gpt.py``,
``paged_verify_attention``'s plain version, and the draft/verify tier of
``serving/generative.py`` and ``serving/paged/server.py``) against the
JAX package, on the CPU.

The JAX package's configs of ``tests/test_generative.py`` (``CFG``:
vocab 64, hidden 32, 2 layers, 2 heads, max_seq 32; ``DRAFT_CFG``: hidden
16, 1 layer, seed 1, an independent low-acceptance draft) and GPT_TINY;
the same weights go into both packages through
``convert.samediff_arrays_from_jax``, float32 on both sides.

Tolerances: ``paged_verify_plain``'s active rows within 1e-6 of the JAX
write-then-attend (float32 sums in another order; with x64 on, the JAX
softmax runs in float64 because its scale is a numpy float64), the slabs
it writes bit for bit; the verify functions' logits within 1e-5 of their
largest magnitude and their argmax equal. Speculative servers' greedy
tokens equal the port's ``greedy_decode`` bit for bit and the JAX
package's greedy tokens.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.serving.generative import \
    greedy_decode as jax_greedy_decode
from deeplearning4j_tpu.zoo import gpt as jgpt
from deeplearning4j_tpu_torch.convert import samediff_arrays_from_jax
from deeplearning4j_tpu_torch.kernels import int8_matmul as im
from deeplearning4j_tpu_torch.kernels import paged_attention as pa
from deeplearning4j_tpu_torch.serving import (GenerativeMetrics,
                                              GenerativeServer, greedy_decode)
from deeplearning4j_tpu_torch.serving.paged import (NULL_BLOCK,
                                                    PagedGenerativeServer)
from deeplearning4j_tpu_torch.zoo import gpt as pgpt

MSL = 32
BS = 8
MAXB = MSL // BS
JCFG = jgpt.GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                      num_heads=2, intermediate_size=64, max_seq_len=MSL)
PCFG = pgpt.GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                      num_heads=2, intermediate_size=64, max_seq_len=MSL)
JDRAFT = jgpt.GPTConfig(vocab_size=64, hidden_size=16, num_layers=1,
                        num_heads=2, intermediate_size=32, max_seq_len=MSL)
PDRAFT = pgpt.GPTConfig(vocab_size=64, hidden_size=16, num_layers=1,
                        num_heads=2, intermediate_size=32, max_seq_len=MSL)


def _port_from_jax(jsd, cfg, seed=5):
    sd = pgpt.build_gpt(cfg, batch=2, seq_len=8, seed=seed, device="cpu")
    return samediff_arrays_from_jax(
        {n: np.asarray(a, np.float32)
         for n, a in jsd.trainable_params().items()}, sd)


@pytest.fixture(scope="module")
def jsd():
    return jgpt.build_gpt(JCFG, batch=2, seq_len=8, seed=0)


@pytest.fixture(scope="module")
def psd(jsd):
    return _port_from_jax(jsd, PCFG)


@pytest.fixture(scope="module")
def jdsd():
    return jgpt.build_gpt(JDRAFT, batch=2, seq_len=8, seed=1)


@pytest.fixture(scope="module")
def pdsd(jdsd):
    return _port_from_jax(jdsd, PDRAFT, seed=6)


@pytest.fixture(scope="module")
def spec(psd):
    return pgpt.gpt_generative_spec(psd, PCFG)


@pytest.fixture(scope="module")
def draft(pdsd):
    return pgpt.gpt_generative_spec(pdsd, PDRAFT)


def mixed_prompts(n=6, seed=0, max_len=12):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, PCFG.vocab_size,
                         int(rng.integers(1, max_len + 1)))
            .astype(np.int32) for _ in range(n)]


def _close(got, want, rtol=1e-5):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= rtol * max(float(np.max(np.abs(want))), 1e-30), err


def _i32(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.int32))


def make(kind, spec_or_sd, draft=None, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_seq_len", MSL)
    kw.setdefault("warmup", False)
    kw.setdefault("device", "cpu")
    if draft is not None:
        kw.setdefault("draft_spec", draft)
        kw.setdefault("speculate_k", 4)
    if kind == "paged":
        kw.setdefault("block_size", BS)
        kw.setdefault("debug_leaks", True)
        return PagedGenerativeServer(spec_or_sd, **kw)
    return GenerativeServer(spec_or_sd, **kw)


# ----------------------------------------------------------------------
# paged_verify_plain against the JAX verify write-then-attend
def _jax_verify_attention(q, kc, vc, tables, pos):
    """zoo/gpt.py gpt_paged_decode_fns.verify_fn :737-751 (one layer, q
    [S, W, A, D], the cache already written)."""
    S, W, A, D = q.shape
    T = tables.shape[1] * kc.shape[2]
    ctx_k = jnp.transpose(kc[tables], (0, 2, 1, 3, 4)).reshape(S, A, T, D)
    ctx_v = jnp.transpose(vc[tables], (0, 2, 1, 3, 4)).reshape(S, A, T, D)
    mask = jnp.arange(T)[None, None, :] <= pos[:, :, None]
    vmask = jnp.arange(T)[None, :] <= pos[:, -1][:, None]
    scores = jnp.einsum("swad,satd->swat", q, ctx_k,
                        preferred_element_type=jnp.float32) / np.sqrt(D)
    scores = jnp.where(mask[:, :, None, :], scores, jnp.float32(-1e30))
    probs = jax.nn.softmax(scores, axis=-1).astype(ctx_v.dtype)
    v_safe = jnp.where(vmask[:, None, :, None], ctx_v, 0)
    return jnp.einsum("swat,satd->swad", probs, v_safe)


def _rows(s, w, a, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(s, w, a, d)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("w", [2, 5, 16, 20])
@pytest.mark.parametrize("bs", [1, 16])
def test_plain_verify_matches_the_jax_paged_verify(bs, w):
    """Lanes whose windows start at key 0, at a block's last row and
    inside a block, one lane inactive (the JAX scatter sends its W rows to
    the null block; the port writes nothing): the active rows within 1e-6
    of the JAX write-then-attend, the slabs after the write bit for bit
    but the null block, which the port leaves untouched (NaN there and in
    the unused blocks reaches no row)."""
    a, d = 2, 16
    pos0 = np.array([0, bs - 1, 3 * bs + 2, 7], np.int32)
    active = np.array([True, True, False, True])
    maxb = -(-(int(pos0.max()) + w) // bs)
    nb = 4 * maxb + 2
    rng = np.random.default_rng(bs + w)
    kc, vc = (rng.normal(size=(nb, a, bs, d)).astype(np.float32)
              for _ in range(2))
    kc[NULL_BLOCK] = vc[NULL_BLOCK] = np.nan
    kc[nb - 1] = vc[nb - 1] = np.nan
    tables = np.zeros((4, maxb), np.int32)
    for s in range(4):
        tables[s] = 1 + s * maxb + np.arange(maxb)
    pos = pos0[:, None] + np.arange(w)[None, :]                 # [S, W]
    q, k, v = _rows(4, w, a, d, seed=w)
    wb = np.where(active[:, None], tables[np.arange(4)[:, None], pos // bs],
                  NULL_BLOCK)
    wo = np.where(active[:, None], pos % bs, 0)
    ai = jnp.arange(a)
    jkc = jnp.asarray(kc).at[wb[:, :, None], ai[None, None, :],
                             wo[:, :, None]].set(jnp.asarray(k))
    jvc = jnp.asarray(vc).at[wb[:, :, None], ai[None, None, :],
                             wo[:, :, None]].set(jnp.asarray(v))
    want = _jax_verify_attention(jnp.asarray(q), jkc, jvc,
                                 jnp.asarray(tables), jnp.asarray(pos))
    pkc, pvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    act = np.repeat(active, w)
    lanes = np.repeat(np.arange(4), w)
    got = pa.paged_verify_attention(
        *(torch.from_numpy(x.reshape(4 * w, a, d)) for x in (q, k, v)), pkc,
        pvc, _i32(tables), _i32(lanes),
        _i32(np.where(act, pos.reshape(-1), 0)),
        _i32(np.where(act, pos0[lanes], -1)), _i32(lanes * w),
        _i32(np.where(act, wb.reshape(-1), -1)), _i32(wo.reshape(-1)))
    assert torch.isfinite(got[act]).all()
    _close(got[act], np.asarray(want).reshape(4 * w, a, d)[act], rtol=1e-6)
    for pt, jt, orig in ((pkc, jkc, kc), (pvc, jvc, vc)):
        np.testing.assert_array_equal(pt[1:].numpy(), np.asarray(jt)[1:])
        np.testing.assert_array_equal(pt[NULL_BLOCK].numpy(),
                                      orig[NULL_BLOCK])
    assert pa.LAUNCHES["paged_verify_attention"] == 0


@pytest.mark.parametrize("w", [2, 8, 20])
def test_plain_verify_matches_the_jax_dense_verify(w):
    """The dense slab as a paged one (``BS = max_seq``, table ``[s]``):
    the active slots' rows within 1e-6 of the JAX dense verify
    (zoo/gpt.py :437-459), the whole slab after the write bit for bit
    (both keep an inactive slot's rows)."""
    a, d, t = 2, 16, 48
    rng = np.random.default_rng(w)
    kc, vc = (rng.normal(size=(3, a, t, d)).astype(np.float32)
              for _ in range(2))
    pos0 = np.array([0, 9, 20], np.int32)
    active = np.array([True, False, True])
    pos = pos0[:, None] + np.arange(w)[None, :]
    q, k, v = _rows(3, w, a, d, seed=w + 1)
    si, ai = jnp.arange(3), jnp.arange(a)
    idx = (si[:, None, None], ai[None, None, :], jnp.asarray(pos)[:, :, None])
    ok = jnp.asarray(active)[:, None, None, None]
    jkc = jnp.asarray(kc).at[idx].set(jnp.where(ok, k, jnp.asarray(kc)[idx]))
    jvc = jnp.asarray(vc).at[idx].set(jnp.where(ok, v, jnp.asarray(vc)[idx]))
    want = _jax_verify_attention(jnp.asarray(q), jkc, jvc,
                                 jnp.arange(3)[:, None], jnp.asarray(pos))
    pkc, pvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    act = np.repeat(active, w)
    lanes = np.repeat(np.arange(3), w)
    got = pa.paged_verify_attention(
        *(torch.from_numpy(x.reshape(3 * w, a, d)) for x in (q, k, v)),
        pkc, pvc, _i32(np.arange(3)[:, None]), _i32(lanes),
        _i32(np.where(act, pos.reshape(-1), 0)),
        _i32(np.where(act, pos0[lanes], -1)), _i32(lanes * w),
        _i32(np.where(act, lanes, -1)), _i32(pos.reshape(-1)))
    _close(got[act], np.asarray(want).reshape(3 * w, a, d)[act], rtol=1e-6)
    np.testing.assert_array_equal(pkc.numpy(), np.asarray(jkc))
    np.testing.assert_array_equal(pvc.numpy(), np.asarray(jvc))


def test_plain_verify_rows_equal_plain_decode_rows():
    """Row w of a verify is the decode at last key pos0 + w over the same
    keys: the verify's outputs equal ``paged_decode_attention``'s on the
    cache the verify wrote, each row writing its own key again."""
    from deeplearning4j_tpu_torch.kernels import measure
    case = measure.paged_verify_case(torch.device("cpu"), [0, 15, 40, 3], 6,
                                     2, 16, 16, torch.float64,
                                     active=[True, True, False, True])
    q, kn, vn, kc, vc, tab, lane, kmax, win0, wrow, wb, wo = case
    got = pa.paged_verify_attention(q, kn, vn, kc, vc, tab, lane, kmax,
                                    win0, wrow, wb, wo)
    k2, v2 = kc.clone(), vc.clone()
    dec = pa.paged_decode_attention(q, kn, vn, k2, v2, tab, lane, kmax, wb,
                                    wo)
    _close(got, dec, rtol=1e-12)
    assert torch.equal(k2, kc) and torch.equal(v2, vc)


def test_plain_verify_refuses_a_window_past_the_rows():
    """A row whose window would take new rows past the launch's (or before
    its first) is refused as the kernel refuses it: its output is NaN, its
    write still made; the other rows' outputs are unchanged."""
    from deeplearning4j_tpu_torch.kernels import measure
    case = measure.paged_verify_case(torch.device("cpu"), [0, 15, 40, 3], 6,
                                     2, 16, 16, torch.float64, seed=4)
    ref = [t.clone() for t in case]
    bad = [t.clone() for t in case]
    n = bad[0].shape[0]
    bad[9][6:9] = torch.tensor([n, n - 1, n - 2])  # the last row past n - 1
    bad[9][9:12] = -1
    got = pa.paged_verify_plain(*bad)
    want = pa.paged_verify_plain(*ref)
    assert torch.isnan(got[6:12]).all()
    assert torch.equal(got[:6], want[:6]) and torch.equal(got[12:], want[12:])
    assert torch.equal(bad[3], ref[3]) and torch.equal(bad[4], ref[4])


def test_verify_bounds_read_each_lane_below_its_window_once():
    """``paged_bounds`` with ``win0``: each lane's keys below its window
    read once (an inactive lane's key 0), its window's keys taken from the
    new rows; q, out and each writing row's K/V rows as at decode."""
    from deeplearning4j_tpu_torch.kernels import measure
    pos0, w, a, d = [0, 15, 40, 3], 6, 2, 16
    case = measure.paged_verify_case(torch.device("cpu"), pos0, w, a, d, 16,
                                     torch.float32,
                                     active=[True, True, False, True])
    q, kn, vn, kc, vc, tab, lane, kmax, win0, wrow, wb, wo = case
    writes = int((wb >= 0).sum())
    ops, nbytes = measure.paged_bounds(q, kc, tab, lane, kmax, writes, win0)
    keys = sum(p + j + 1 for s, p in enumerate(pos0) if s != 2
               for j in range(w)) + w
    assert writes == 3 * w and ops == 4 * d * a * keys
    row = a * d * 4
    cached = 0 + 15 + 1 + 3                    # lane 2 reads its key 0
    assert nbytes == (2 * cached + 2 * len(q) + 4 * writes) * row
    _, decode_bytes = measure.paged_bounds(q, kc, tab, lane, kmax, writes)
    assert decode_bytes - nbytes == 2 * 3 * w * row   # the active windows


@pytest.mark.parametrize("bad,match", [
    (dict(win0=torch.zeros(3, dtype=torch.int32)), "win0"),
    (dict(wrow=torch.zeros(2, 1, dtype=torch.int32)), "wrow"),
    (dict(k_new=torch.zeros(2, 2, 8)), "must be q's"),
])
def test_verify_wrapper_refuses_mismatched_inputs(bad, match):
    z = torch.zeros(2, dtype=torch.int32)
    args = dict(q=torch.zeros(2, 2, 16), k_new=torch.zeros(2, 2, 16),
                v_new=torch.zeros(2, 2, 16), kc=torch.zeros(4, 2, 8, 16),
                vc=torch.zeros(4, 2, 8, 16),
                tables=torch.zeros(2, 3, dtype=torch.int32), lane=z,
                kmax=z, win0=z, wrow=z, write_block=z, write_off=z)
    args.update(bad)
    with pytest.raises(ValueError, match=match):
        pa.paged_verify_attention(**args)


# ----------------------------------------------------------------------
# the verify functions against the JAX package's
def _params(jsd, psd, cfg_j, qw):
    names = jgpt.gpt_param_names(cfg_j)
    jp = {n: jsd._arrays[n] for n in names}
    pp = {n: psd.get_arr_for_var(n) for n in names}
    if qw:
        jp = jgpt.gpt_quantize_params(jp, cfg_j)
        pp = pgpt.gpt_quantize_params(pp, pgpt.GPTConfig(
            **dataclasses.asdict(cfg_j)))
    return jp, pp


def _verify_io(paged, s_n, w, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 64, size=(s_n, w)).astype(np.int32)
    pos0 = np.array([0, 7, 13, 20][:s_n], np.int32)
    active = np.array([True, True, False, True][:s_n])
    io = {"tokens": tokens, "positions": pos0, "active": active}
    if paged:
        tables = (1 + np.arange(s_n)[:, None] * MAXB
                  + np.arange(MAXB)[None, :]).astype(np.int32)
        pos = pos0[:, None] + np.arange(w)[None, :]
        io.update(tables=tables,
                  write_block=np.where(active[:, None], tables[
                      np.arange(s_n)[:, None], pos // BS], NULL_BLOCK
                  ).astype(np.int32),
                  write_off=(pos % BS).astype(np.int32))
    return io


@pytest.mark.parametrize("qw", [False, True])
@pytest.mark.parametrize("paged", [False, True])
def test_verify_fn_matches_jax(jsd, psd, paged, qw):
    """Both verify functions, float32 and int8 weights, over slabs of the
    same random contents: the active lanes' logits within 1e-5 of their
    magnitude, the greedy tokens equal, and the slabs' written rows (all
    but the null block) equal to 1e-5."""
    w = 5
    jp, pp = _params(jsd, psd, JCFG, qw)
    if paged:
        jf = jgpt.gpt_paged_decode_fns(JCFG, BS, MAXB, quantize_weights=qw)
        pf = pgpt.gpt_paged_decode_fns(PCFG, BS, MAXB, quantize_weights=qw)
        shape = (2, 1 + 4 * MAXB, 2, BS, 16)
    else:
        jf = jgpt.gpt_decode_fns(JCFG, quantize_weights=qw)
        pf = pgpt.gpt_decode_fns(PCFG, quantize_weights=qw)
        shape = (2, 4, 2, MSL, 16)
    rng = np.random.default_rng(3)
    kc, vc = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    io = _verify_io(paged, 4, w, seed=4)
    jkc, jvc, jo, jl = jf[2](jp, jnp.asarray(kc), jnp.asarray(vc), io)
    pkc, pvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    with torch.inference_mode():
        rkc, rvc, po, pl = pf[2](pp, pkc, pvc, io)
    assert rkc is pkc and rvc is pvc and po.shape == (4, w)
    act = io["active"]
    _close(pl[act], np.asarray(jl)[act])
    np.testing.assert_array_equal(po.numpy()[act], np.asarray(jo)[act])
    lo = 1 if paged else 0
    _close(pkc[:, lo:], np.asarray(jkc)[:, lo:])
    _close(pvc[:, lo:], np.asarray(jvc)[:, lo:])


@pytest.mark.parametrize("paged", [False, True])
def test_verify_fns_launch_once_a_layer(monkeypatch, psd, paged):
    """With the card's launch stubbed (the wrapper's checks pass as for a
    CUDA tensor), each verify function calls ``paged_verify_attention``
    once a layer over all S W rows, with each lane's window (``win0``
    its first position, ``wrow`` its first row), the rows' last keys and
    write places; an inactive lane writes nothing (-1) and takes no
    window."""
    launches = []
    monkeypatch.setattr(pa, "_check", lambda q, *a: types.SimpleNamespace(
        type="cuda"))
    monkeypatch.setattr(pa, "_check_verify", lambda *a: None)
    monkeypatch.setattr(pa, "_launch", lambda q, kc, vc, tables, lane, kmax,
                        write=None, window=None, **kw: launches.append(
                            (kc.data_ptr(), lane, kmax, write, window))
                        or torch.zeros_like(q))
    pa.reset_launches()
    w = 4
    io = _verify_io(paged, 4, w, seed=1)
    fns = pgpt.gpt_paged_decode_fns(PCFG, BS, MAXB) if paged else \
        pgpt.gpt_decode_fns(PCFG)
    pp = {n: psd.get_arr_for_var(n) for n in pgpt.gpt_param_names(PCFG)}
    shape = (2, 1 + 4 * MAXB, 2, BS, 16) if paged else (2, 4, 2, MSL, 16)
    kc, vc = torch.zeros(shape), torch.zeros(shape)
    with torch.inference_mode():
        fns[2](pp, kc, vc, io)
    assert pa.LAUNCHES == {"paged_attention": 0, "paged_decode_attention": 0,
                           "paged_verify_attention": PCFG.num_layers}
    assert len(launches) == PCFG.num_layers
    act = np.repeat(io["active"], w)
    pos = (io["positions"][:, None] + np.arange(w)[None, :]).reshape(-1)
    lanes = np.repeat(np.arange(4), w)
    for i, (ptr, lane, kmax, write, window) in enumerate(launches):
        assert ptr == kc[i].data_ptr()
        k_new, v_new, wb, wo = write
        win0, wrow = window
        assert k_new.shape == (4 * w, 2, 16)
        np.testing.assert_array_equal(lane.numpy(), lanes)
        np.testing.assert_array_equal(kmax.numpy(), np.where(act, pos, 0))
        np.testing.assert_array_equal(
            win0.numpy(), np.where(act, io["positions"][lanes], -1))
        np.testing.assert_array_equal(wrow.numpy(), lanes * w)
        want_wb = io["write_block"].reshape(-1) if paged else lanes
        np.testing.assert_array_equal(wb.numpy(), np.where(act, want_wb, -1))
        np.testing.assert_array_equal(wo.numpy()[act], (
            pos % BS if paged else pos)[act])


def test_verify_rows_equal_decode_rows(psd):
    """Inside the port, verify row w is the decode step fed the window's
    first w + 1 tokens: out[:, j] equals the greedy tokens of W plain
    decode steps."""
    pf = pgpt.gpt_decode_fns(PCFG)
    pp = {n: psd.get_arr_for_var(n) for n in pgpt.gpt_param_names(PCFG)}
    rng = np.random.default_rng(9)
    shape = (2, 2, 2, MSL, 16)
    kc, vc = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
              for _ in range(2))
    tokens = rng.integers(0, 64, size=(2, 4)).astype(np.int32)
    pos0 = np.array([3, 11], np.int32)
    io = {"tokens": tokens, "positions": pos0,
          "active": np.array([True, True])}
    with torch.inference_mode():
        _, _, out, logits = pf[2](pp, kc.clone(), vc.clone(), io)
        dk, dv = kc.clone(), vc.clone()
        for j in range(4):
            dk, dv, nxt, lg = pf[1](pp, dk, dv, {
                "tokens": tokens[:, j], "positions": pos0 + j,
                "active": np.array([True, True])})
            _close(logits[:, j], lg.numpy(), rtol=1e-6)
            np.testing.assert_array_equal(out[:, j].numpy(), nxt.numpy())


# ----------------------------------------------------------------------
# the speculative servers
def _jax_ref(jsd, prompts, n):
    jspec = jgpt.gpt_generative_spec(jsd, JCFG)
    return [jax_greedy_decode(jspec, p, n, max_seq_len=MSL) for p in prompts]


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_independent_draft_matches_greedy_and_jax(kind, jsd, psd, spec,
                                                  draft):
    """An independent low-acceptance draft: every request equals the
    port's ``greedy_decode`` and the JAX package's greedy tokens; rounds
    ran and drafts were rejected (the rollback path), nothing leaked."""
    prompts = mixed_prompts(6, seed=2)
    target = spec if kind == "dense" else pgpt.gpt_paged_spec(psd, PCFG)
    with make(kind, target, draft) as srv:
        got = [h.result(timeout=120) for h in
               [srv.submit(p, max_new_tokens=10) for p in prompts]]
    g = srv.metrics.to_record()["generative"]
    assert got == [greedy_decode(spec, p, 10, max_seq_len=MSL, device="cpu")
                   for p in prompts]
    assert got == _jax_ref(jsd, prompts, 10)
    assert g["spec_rounds"] >= 1 and g["draft_rejected"] >= 1
    assert g["draft_tokens"] == g["draft_accepted"] + g["draft_rejected"]
    if kind == "paged":
        assert srv.pool.stats()["held"] == 0


@pytest.mark.parametrize("kind", ["dense", "paged"])
@pytest.mark.parametrize("qw", [False, True])
def test_self_draft_matches_greedy(kind, qw, jsd, psd):
    """The JAX benchmark's self-draft pairing (layers 1.. with their
    residual-out projections zeroed, a 1-layer draft over the same
    weights), float32 and int8 weights: every request equals
    ``greedy_decode`` of the target and, in float32, the JAX package's
    greedy tokens of the same zeroed model; acceptance is high."""
    jz = jgpt.build_gpt(JCFG, batch=2, seq_len=8, seed=0)
    for part in ("attn/proj", "mlp/proj"):
        for leaf in ("kernel", "bias"):
            n = f"h1/{part}/{leaf}"
            jz._arrays[n] = jnp.zeros_like(jz._arrays[n])
    sd = _port_from_jax(jz, PCFG)
    dcfg = dataclasses.replace(PCFG, num_layers=1)
    ref = pgpt.gpt_generative_spec(sd, PCFG, quantize_weights=qw)
    target = ref if kind == "dense" else pgpt.gpt_paged_spec(
        sd, PCFG, quantize_weights=qw)
    dspec = pgpt.gpt_generative_spec(sd, dcfg, quantize_weights=qw)
    prompts = mixed_prompts(5, seed=6)
    with make(kind, target, dspec, speculate_k=8) as srv:
        got = [h.result(timeout=120) for h in
               [srv.submit(p, max_new_tokens=14) for p in prompts]]
    assert got == [greedy_decode(ref, p, 14, max_seq_len=MSL, device="cpu")
                   for p in prompts]
    if not qw:
        jspec = jgpt.gpt_generative_spec(jz, JCFG)
        assert got == [jax_greedy_decode(jspec, p, 14, max_seq_len=MSL)
                       for p in prompts]
    g = srv.metrics.to_record()["generative"]
    assert g["spec_rounds"] >= 1 and g["draft_accepted"] >= 1


def test_int8_speculative_matches_jax_int8_greedy(jsd, psd, jdsd, pdsd):
    """int8 target and int8 draft: the served tokens equal the JAX
    package's int8 greedy tokens for the same weights."""
    prompts = mixed_prompts(4, seed=8)
    target = pgpt.gpt_paged_spec(psd, PCFG, quantize_weights=True)
    dspec = pgpt.gpt_generative_spec(pdsd, PDRAFT, quantize_weights=True)
    with make("paged", target, dspec) as srv:
        got = [h.result(timeout=120) for h in
               [srv.submit(p, max_new_tokens=9) for p in prompts]]
    jspec = jgpt.gpt_generative_spec(jsd, JCFG, quantize_weights=True)
    assert got == [jax_greedy_decode(jspec, p, 9, max_seq_len=MSL)
                   for p in prompts]


def test_sampled_request_same_with_and_without_draft(spec, draft):
    """A seeded sampled request gives the same tokens with and without a
    draft (the proposal takes the target's (seed, index) draw; every
    emitted token is the target's own sample)."""
    p = mixed_prompts(1, seed=11)[0]
    kw = dict(temperature=0.9, top_k=20, seed=123)
    with make("dense", spec) as srv:
        plain = srv.submit(p, max_new_tokens=12, **kw).result(timeout=60)
    with make("dense", spec, draft) as srv:
        spec_out = srv.submit(p, max_new_tokens=12, **kw).result(timeout=60)
    assert spec_out == plain
    assert srv.metrics.counters["spec_rounds"] >= 1


def test_pairing_validation(spec, psd, pdsd):
    """The JAX pairing errors: vocabulary mismatch, a draft shorter than
    the served sequence, ``speculate_k < 2``, a draft that is no spec."""
    odd = pgpt.GPTConfig(vocab_size=32, hidden_size=16, num_layers=1,
                         num_heads=2, intermediate_size=32, max_seq_len=MSL)
    osd = pgpt.build_gpt(odd, batch=2, seq_len=8, seed=2, device="cpu")
    with pytest.raises(ValueError, match="vocab_size"):
        make("dense", spec, pgpt.gpt_generative_spec(osd, odd))
    short = dataclasses.replace(PDRAFT, max_seq_len=16)
    ssd = pgpt.build_gpt(short, batch=2, seq_len=8, seed=2, device="cpu")
    with pytest.raises(ValueError, match="max_seq_len"):
        make("dense", spec, pgpt.gpt_generative_spec(ssd, short))
    draft = pgpt.gpt_generative_spec(pdsd, PDRAFT)
    with pytest.raises(ValueError, match="speculate_k"):
        make("paged", pgpt.gpt_paged_spec(psd, PCFG), draft, speculate_k=1)
    with pytest.raises(TypeError, match="draft"):
        make("dense", spec, object())


def test_rejected_tails_leak_no_block(psd, draft):
    """``debug_leaks`` audits the pool after every round: with a
    low-acceptance draft many window tails are rejected, each lane's
    table grew to its window up front, and the pool drains clean; a
    prefix hit reuses blocks under speculation."""
    target = pgpt.gpt_paged_spec(psd, PCFG)
    shared = np.arange(17, dtype=np.int32) % 64
    prompts = [shared, shared] + mixed_prompts(4, seed=12, max_len=20)
    with make("paged", target, draft, num_blocks=40) as srv:
        got = [h.result(timeout=120) for h in
               [srv.submit(p, max_new_tokens=11) for p in prompts]]
    assert srv.metrics.counters["draft_rejected"] >= 4
    assert srv.metrics.counters["prefix_blocks_hit"] >= 1
    assert srv.pool.stats()["held"] == 0
    srv.pool.check_invariant(tables=[])
    dense = pgpt.gpt_generative_spec(psd, PCFG)
    assert got == [greedy_decode(dense, p, 11, max_seq_len=MSL,
                                 device="cpu") for p in prompts]


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_warmup_covers_verify_and_draft(kind, psd, draft):
    """Warmup runs the decode step, every prefill bucket, the verify at the
    window's shape and the draft's decode and prefill buckets: 1 + 6 + 1 +
    1 + 6 shapes; traffic adds none."""
    target = pgpt.gpt_generative_spec(psd, PCFG, quantize_weights=True) \
        if kind == "dense" else pgpt.gpt_paged_spec(psd, PCFG,
                                                    quantize_weights=True)
    with make(kind, target, draft, warmup=True) as srv:
        assert srv.warmup_report["speculative"] is True
        assert srv.metrics.counters["warmup_compiles"] == 15
        for p in mixed_prompts(4, seed=13):
            srv.generate(p, max_new_tokens=6)
        assert srv.metrics.counters["compiles"] == 0


def test_update_model_requantizes_and_refreshes_the_draft(psd, pdsd):
    """``update_model`` re-pulls: a quantized target serves the new
    weights re-quantized, and the draft's parameters are pulled again."""
    from deeplearning4j_tpu_torch.convert import samediff_arrays_from_jax
    sd = pgpt.build_gpt(PCFG, batch=2, seq_len=8, seed=5, device="cpu")
    samediff_arrays_from_jax({n: psd.get_arr_for_var(n).numpy()
                              for n in pgpt.gpt_param_names(PCFG)}, sd)
    dsd = pgpt.build_gpt(PDRAFT, batch=2, seq_len=8, seed=6, device="cpu")
    samediff_arrays_from_jax({n: pdsd.get_arr_for_var(n).numpy()
                              for n in pgpt.gpt_param_names(PDRAFT)}, dsd)
    target = pgpt.gpt_generative_spec(sd, PCFG, quantize_weights=True)
    dspec = pgpt.gpt_generative_spec(dsd, PDRAFT, quantize_weights=True)
    p = mixed_prompts(1, seed=14)[0]
    with make("dense", target, dspec) as srv:
        before = srv.generate(p, max_new_tokens=8)
        old_draft = srv._draft_params["wte"]
        w = torch.flip(sd.get_arr_for_var("wte"), [0]) * 3.0
        sd.set_arr_for_var("wte", w)
        # the final layer norm's shift points at token 7's embedding
        sd.set_arr_for_var("ln_f/beta", w[7] * 100.0)
        dw = dsd.get_arr_for_var("wte")
        dsd.set_arr_for_var("wte", torch.flip(dw, [0]))
        srv.update_model()
        after = srv.generate(p, max_new_tokens=8)
        assert not torch.equal(srv._draft_params["wte"], old_draft)
        q = pgpt.gpt_quantize_params({"wte": w}, PCFG)
        for n in ("wte", "wte::scale"):
            assert torch.equal(srv._params[n], q[n])
    assert after == greedy_decode(target, p, 8, max_seq_len=MSL,
                                  device="cpu")
    assert after != before and after == [7] * 8


def test_metrics_record_and_stats_line(spec, draft):
    """The speculative counters, the acceptance rate in ``to_record`` and
    the ``stats()`` line; a record with no round keeps them at 0."""
    rec = GenerativeMetrics(4).to_record()["generative"]
    assert rec["spec_rounds"] == 0 and rec["draft_acceptance_rate"] == 0.0
    m = GenerativeMetrics(4)
    m.observe_spec_round(6, 4)
    m.observe_spec_round(3, 0)
    g = m.to_record()["generative"]
    assert (g["spec_rounds"], g["draft_tokens"], g["draft_accepted"],
            g["draft_rejected"]) == (2, 9, 4, 5)
    assert g["draft_acceptance_rate"] == round(4 / 9, 4)
    assert "speculative: 2 rounds, acceptance 44.4% (4/9 drafts)" \
        in m.stats()
    assert "speculative:" not in GenerativeMetrics(4).stats()


def test_quantize_kv_still_refused_by_name(psd):
    """int8 KV was refused by name until it was ported; both specs now
    take ``quantize_kv`` with int8 weights, and speculation over them
    gives the tokens of the same target without a draft."""
    target = pgpt.gpt_paged_spec(psd, PCFG, quantize_weights=True,
                                 quantize_kv=True)
    draft = pgpt.gpt_generative_spec(
        psd, dataclasses.replace(PCFG, num_layers=1), quantize_weights=True,
        quantize_kv=True)
    assert target.kv_dtype == draft.kv_dtype == "int8"
    prompt = np.arange(2, 9, dtype=np.int32)
    kw = dict(max_slots=2, max_seq_len=MSL, block_size=BS, device="cpu")
    with PagedGenerativeServer(target, **kw) as srv:
        plain = srv.submit(prompt, max_new_tokens=7).result(timeout=60)
    with PagedGenerativeServer(target, draft_spec=draft, speculate_k=4,
                               **kw) as srv:
        assert srv.submit(prompt, max_new_tokens=7).result(
            timeout=60) == plain


def test_speculative_spans_and_kernel_counts_stay_zero_on_the_cpu(spec,
                                                                   draft):
    """On the CPU the wrappers take their plain versions: no kernel is
    counted, and the tracer records the draft and verify dispatches."""
    from deeplearning4j_tpu_torch.monitor.trace import TRACER
    pa.reset_launches()
    im.reset_launches()
    TRACER.reset()
    TRACER.enable()
    try:
        with make("dense", spec, draft) as srv:
            srv.generate(mixed_prompts(1, seed=15)[0], max_new_tokens=6)
    finally:
        TRACER.disable()
    names = {s.name for s in TRACER.spans()}
    TRACER.reset()
    assert {"serving.draft", "serving.verify"} <= names
    assert pa.LAUNCHES["paged_verify_attention"] == 0
    assert im.LAUNCHES["int8_matmul"] == 0


# ----------------------------------------------------------------------
# the verify entry of csrc/paged_attention.cu
def test_verify_ctypes_declaration_matches_the_c_entry():
    import ctypes
    import pathlib
    import re
    src = (pathlib.Path(pa.__file__).resolve().parents[1] / "csrc"
           / "paged_attention.cu").read_text()
    m = re.search(r'extern "C" int ' + pa.VERIFY_ENTRY + r'\((.*?)\)\s*\{',
                  src, re.S)
    params = [p.strip() for p in m.group(1).split(",")]
    params = [(" ".join(p.split()[:-1]), p.split()[-1]) for p in params]
    c_types = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
               "int64_t": ctypes.c_int64, "int": ctypes.c_int,
               "double": ctypes.c_double}
    assert [n for _, n in params] == [n for n, _ in pa.VERIFY_ARGTYPES]
    assert [c_types[t] for t, _ in params] == \
        [t for _, t in pa.VERIFY_ARGTYPES]
    assert pa.ENTRIES[pa.VERIFY_ENTRY] is pa.VERIFY_ARGTYPES


def test_verify_runs_the_decode_kernel_with_windows():
    """The verify entry launches its own kernel (``paged_verify_kernel``),
    one cluster a group of 8 rows and head, whose blocks take the decode's
    8 ranks in turn (rank r's chunks r, r + 8, ... as the decode block of
    rank r takes them), and the decode entry still the decode kernel,
    which knows no window. Each row runs the decode kernel's per-key
    arithmetic, statement for statement (the same dot,
    butterfly, masked score, running max, correction and V sums, a row's
    own in the decode kernel's order, the rows side by side), over
    chunks copied once a run; a key at or past a row's window start is a
    new row put in the chunk, never a cache read (the copy skips it), and
    each row's 8 partials are combined in rank order as the decode's.
    Float64 rows over an int8 cache read each stored value dequantised,
    as the float64 decode does; over an int8 cache in float32 the launch
    goes to paged_verify_i8_kernel, which takes the decode's fold (q *
    s_k rounded once, the stored integers in the loop, s_v in the
    combine; tests/test_torch_verify_i8.py)."""
    import pathlib
    import re
    code = "\n".join(line.split("//")[0] for line in (
        pathlib.Path(pa.__file__).resolve().parents[1] / "csrc"
        / "paged_attention.cu").read_text().splitlines())

    def entry(name):
        e = code[code.index(f"int {name}("):]
        return e[:e.index("\n}\n")]
    ver = entry("dl4j_paged_verify_attention")
    assert "dec::launch_verify_d<float>(D, a, N, st)" in ver
    assert "dec::launch_verify_d<double>(D, a, N, st)" in ver
    assert "static_cast<const int*>(win0), static_cast<const int*>(wrow)" \
        in ver
    assert "dec::launch_d<float>(D, a, N, st)" in entry(
        "dl4j_paged_decode_attention")
    assert re.findall(r'extern "C" int (\w+)\(', code) == [
        pa.ENTRY, pa.VERIFY_ENTRY, pa.OCCUPANCY_ENTRY]
    assert "kWindow" not in code
    assert "constexpr int kVRows = 8;" in code
    assert "(N + R - 1) / R * a.A * kVCluster" in code
    assert "__global__ void __cluster_dims__(kVCluster, 1, 1)" in code
    assert re.search(r"constexpr int kVCluster = (1|2|4|8);", code)
    dec = code[code.index("paged_decode_kernel(const Args a)"):]
    dec = dec[:dec.index("\n}\n")]
    assert "win0" not in dec and "wrow" not in dec
    body = code[code.index("paged_verify_kernel(const Args a)"):]
    body = body[:body.index("\n}\n")]
    # the decode's ranks, each block taking its own in turn, each rank's
    # chunks as the decode block of that rank takes them
    assert "for (int rk = rank; rk < kRanks; rk += kVCluster) {" in body
    for d_stmt, v_stmt in (
            ("const int c = rank + kRanks * k;",
             "const int c = rx + kRanks * k;"),
            ("const int mine = nch > rank ? (nch - 1 - rank) / kRanks + 1 : "
             "0;",
             "return nch > rx ? (nch - 1 - rx) / kRanks + 1 : 0;"),
            ("const int t0 = (rank + kRanks * k) * kChunk;",
             "const int t0 = (rk + kRanks * k) * kChunk;")):
        assert d_stmt in dec and v_stmt in body, (d_stmt, v_stmt)
    # rank rk's partial lands in slot rk; the owner waits for every rank's
    # but its own
    assert "part_acc[pr][rk][sl * E + e] = ob[e];" in body
    assert ("owned * (kRanks - kRanks / kVCluster) * (D + 2) *"
            in body)
    # each decode statement and its verify form (row x of the thread's)
    for d_stmt, v_stmt in (
            ("ok[jj] = live && t <= last;",
             "ok[x][jj] = live && t0 + ((sid + S * jj) & (kChunk - 1)) <= "
             "lastr[x];"),
            ("for (int e = 0; e < E; ++e) dot += qr[j][e] * kr[e];",
             "for (int e = 0; e < E; ++e) dot[x] += qr[x][j][e] * kr[j][e];"),
            ("for (int off = G / 2; off > 0; off >>= 1) dot += "
             "__shfl_xor_sync(kFull, dot, off);",
             "for (int x = 0; x < RP; ++x) dot[x] += __shfl_xor_sync(kFull, "
             "dot[x], off);"),
            ("sc[jj] = ok[jj] ? dot * scale : T(-INFINITY);",
             "sc[x][jj] = live && t <= lastr[x] ? dot[x] * scale : "
             "T(-INFINITY);"),
            ("for (int jj = 0; jj < L::KPS; ++jj) mx = sc[jj] > mx ? sc[jj] "
             ": mx;",
             "for (int jj = 0; jj < KPS; ++jj) mx[x] = sc[x][jj] > mx[x] ? "
             "sc[x][jj] : mx[x];"),
            ("if (mx != T(-INFINITY)) {",
             "go[x] = act[x] && mx[x] != T(-INFINITY);"),
            ("const T corr = exp_(m - mx);",
             "const T corr = exp_(m[x] - mx[x]);"),
            ("l *= corr;", "l[x] *= corr;"),
            ("for (int e = 0; e < E; ++e) acc[j][e] *= corr;",
             "for (int e = 0; e < E; ++e) acc[x][j][e] *= corr;"),
            ("if (!ok[jj]) continue;", "if (!go[x] || !ok[x][jj]) continue;"),
            ("const T p = exp_(sc[jj] - mx);",
             "const T p = exp_(sc[x][jj] - mx[x]);"),
            ("l += p;", "l[x] += p;"),
            ("for (int e = 0; e < E; ++e) acc[j][e] += p * vr[e];",
             "for (int e = 0; e < E; ++e) acc[x][j][e] += p * vr[j][e];"),
            ("m = mx;", "if (go[x]) m[x] = mx[x];")):
        assert d_stmt in dec and v_stmt in body, (d_stmt, v_stmt)
    # keys and values read as the decode reads them: the decode folds an
    # int8 cache's scales out of its loop in float32 only, and this
    # kernel serves no such case (a float cache, or float64 over int8:
    # each stored value dequantised as read)
    assert body.count("ldkv<false, T, E>(") == 2
    assert dec.count("ldkv<L::kFold, T, E>(") == 2
    assert "qr[j][e] = fold<L::kFold>(qp[d], scales(0, d));" in dec
    assert "qr[i][j][e] = row < a.N ? qp[d] : T(0);" in body
    assert "kFold" not in body
    assert "if (t <= ulast && !windowed(t)) {" in body
    assert "static_cast<const T*>(kv ? a.v_new : a.k_new)" in body
    assert "res = fold<L::kFold>(oc, scales(1, tid)) / lc;" in dec
    for stmt in ("mb = rm[2 * i] > mb ? rm[2 * i] : mb;",
                 "const T w = exp_(rm[2 * i] - mb);",
                 "lc += part_ml[pr][k][1] * w;",
                 "oc += part_acc[pr][k][d] * w;",
                 "res = oc / lc;"):
        assert stmt in body, stmt
    assert "atomic" not in code
