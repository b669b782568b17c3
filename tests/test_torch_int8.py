"""The port's int8-weight serving (``evaluation/calibration.py``,
``zoo/gpt.py``'s ``gpt_quantize_params`` and int8 decode functions, and
``kernels/int8_matmul.py`` with its CUDA source) against the JAX package,
on the CPU.

The JAX package's config of ``tests/test_generative.py`` (vocab 64,
hidden 32, 2 layers, 2 heads, max_seq 32) and GPT_TINY; the same float32
weights go into both packages through ``convert.samediff_arrays_from_jax``.

Tolerances: scales and int8 payloads bit for bit (the quotient in float32,
``round`` half to even, the clip); ``int8_matmul_plain`` within 1e-5 of
the sum of each output's absolute terms (float32 sums in another order);
the int8 prefill and decode logits within 1e-5 of their largest
magnitude, their greedy tokens equal.
"""
import contextlib
import ctypes
import pathlib
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.evaluation.calibration import \
    channel_scales as jax_channel_scales
from deeplearning4j_tpu.zoo import gpt as jgpt
from deeplearning4j_tpu_torch.convert import samediff_arrays_from_jax
from deeplearning4j_tpu_torch.evaluation import calibration as cal
from deeplearning4j_tpu_torch.kernels import _cuda
from deeplearning4j_tpu_torch.kernels import int8_matmul as im
from deeplearning4j_tpu_torch.zoo import gpt as pgpt

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "deeplearning4j_tpu_torch" / "csrc" / "int8_matmul.cu"
MSL = 32
CFGS = {
    "cfg": (jgpt.GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                           num_heads=2, intermediate_size=64,
                           max_seq_len=MSL),
            pgpt.GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                           num_heads=2, intermediate_size=64,
                           max_seq_len=MSL)),
    "tiny": (jgpt.GPT_TINY, pgpt.GPT_TINY)}


@pytest.fixture(scope="module", params=sorted(CFGS))
def pair(request):
    jcfg, pcfg = CFGS[request.param]
    jsd = jgpt.build_gpt(jcfg, batch=2, seq_len=8, seed=0)
    psd = pgpt.build_gpt(pcfg, batch=2, seq_len=8, seed=9, device="cpu")
    samediff_arrays_from_jax({n: np.asarray(a, np.float32) for n, a in
                              jsd.trainable_params().items()}, psd)
    return jcfg, pcfg, jsd, psd


def _samples(seed):
    """[40, 7] observations: channel 2 all zero, channel 4 all NaN,
    channel 5 with an Inf and a NaN among finite values, channel 6 an
    outlier tail."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(40, 7)).astype(np.float32)
    x[:, 2] = 0
    x[:, 4] = np.nan
    x[3, 5], x[7, 5] = np.inf, np.nan
    x[0, 6] = 50.0
    return x


def _close(got, want, rtol=1e-5):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= rtol * max(float(np.max(np.abs(want))), 1e-30), err


# ----------------------------------------------------------------------
# calibration
@pytest.mark.parametrize("kw", [
    dict(method="absmax"), dict(method="quantile"),
    dict(method="quantile", quantile=0.9), dict(method="quantile",
                                                  quantile=1.0, num_bins=7),
    dict(method="absmax", qmax=7.0)])
@pytest.mark.parametrize("seed", [0, 1])
def test_channel_scales_equal_the_jax_function(kw, seed):
    x = _samples(seed)
    for obs in (x, x.reshape(5, 8, 7)):
        np.testing.assert_array_equal(cal.channel_scales(obs, **kw),
                                      jax_channel_scales(obs, **kw))
    got = cal.channel_scales(x, **kw)
    assert got.dtype == np.float32 and got[2] == got[4]
    assert np.all(np.isfinite(got)) and np.all(got > 0)


def test_zero_and_nan_channels_get_scale_one():
    s = cal.channel_scales(_samples(0))
    assert s[2] == s[4] == np.float32(1.0)
    assert np.array_equal(s, jax_channel_scales(_samples(0)))


@pytest.mark.parametrize("bad,match", [
    (dict(method="median"), "method"), (dict(quantile=0.0), "quantile"),
    (dict(num_bins=0), "num_bins")])
def test_channel_scales_refuse_what_jax_refuses(bad, match):
    for fn in (cal.channel_scales, jax_channel_scales):
        with pytest.raises(ValueError, match=match):
            fn(_samples(0), **bad)
    with pytest.raises(ValueError, match="channel axis"):
        cal.channel_scales(np.float32(1.0))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_absmax_scales_on_a_tensor_equal_the_host_scales(seed):
    x = _samples(seed)
    np.testing.assert_array_equal(
        cal.absmax_scales(torch.from_numpy(x)).numpy(),
        jax_channel_scales(x, method="absmax"))
    w = np.random.default_rng(seed).normal(size=(3, 16, 24)).astype(
        np.float32) * 0.02
    np.testing.assert_array_equal(
        cal.absmax_scales(torch.from_numpy(w)).numpy(),
        jax_channel_scales(w, method="absmax"))


def test_quantize_symmetric_rounds_half_to_even_and_clips():
    s = torch.tensor([1.0, 0.5], dtype=torch.float32)
    x = torch.tensor([[2.5, 0.75], [-3.5, 70.0], [500.0, -500.0]])
    q = cal.quantize_symmetric(x, s)
    np.testing.assert_array_equal(q.numpy(), np.clip(np.round(
        x.numpy() / s.numpy()), -127, 127).astype(np.int8))
    assert q.dtype == torch.int8 and q.tolist()[0] == [2, 2]


# ----------------------------------------------------------------------
# gpt_quantize_params
def test_quantized_payloads_and_scales_equal_jax_bit_for_bit(pair):
    jcfg, pcfg, jsd, psd = pair
    names = jgpt.gpt_param_names(jcfg)
    jq = jgpt.gpt_quantize_params({n: jsd._arrays[n] for n in names}, jcfg)
    pq = pgpt.gpt_quantize_params({n: psd.get_arr_for_var(n)
                                   for n in names}, pcfg)
    assert sorted(jq) == sorted(pq)
    qnames = set(pgpt._quantized_param_names(pcfg))
    assert qnames == set(jgpt._quantized_param_names(jcfg))
    for n, want in jq.items():
        got = pq[n]
        want = np.asarray(want)
        if n in qnames:
            assert got.dtype == torch.int8 and want.dtype == np.int8
        elif n.endswith("::scale"):
            assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    # wte's channels are its hidden axis
    assert pq["wte::scale"].shape == (pcfg.hidden_size,)


def test_quantized_pull_requantizes_what_the_graph_holds(pair):
    _, pcfg, _, psd = pair
    spec = pgpt.gpt_generative_spec(psd, pcfg, quantize_weights=True)
    first = spec.params()
    w = psd.get_arr_for_var("h0/attn/qkv/kernel")
    psd.set_arr_for_var("h0/attn/qkv/kernel", w * 2.0)
    try:
        again = spec.params()
    finally:
        psd.set_arr_for_var("h0/attn/qkv/kernel", w)
    assert torch.equal(again["h0/attn/qkv/kernel::scale"],
                       first["h0/attn/qkv/kernel::scale"] * 2.0)
    assert torch.equal(again["h0/attn/qkv/kernel"],
                       first["h0/attn/qkv/kernel"])


# ----------------------------------------------------------------------
# int8_matmul's plain version against the JAX expression
@pytest.mark.parametrize("m,k,n", [(1, 64, 192), (8, 32, 96), (13, 128, 64),
                                   (64, 96, 40)])
@pytest.mark.parametrize("transposed", [False, True])
def test_plain_matches_the_jax_expression(m, k, n, transposed):
    from deeplearning4j_tpu_torch.kernels import measure
    x, w, s = measure.int8_matmul_case(torch.device("cpu"), m, k, n,
                                       transposed, seed=m + k)
    xj, wj, sj = (jnp.asarray(t.numpy()) for t in (x, w, s))
    if transposed:          # zoo/gpt.py _logits :287-290
        want = jnp.einsum("...h,vh->...v", xj * sj, wj.astype(jnp.float32))
    else:                   # _matmul :267-268
        want = (xj @ wj.astype(jnp.float32)) * sj
    got = im.int8_matmul(x, w, s, transposed)
    terms = im.abs_terms(x, w, s, transposed).numpy()
    err = np.abs(got.double().numpy() - np.asarray(want, np.float64))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert np.all(err <= 1e-5 * terms + 1e-30)
    assert im.LAUNCHES["int8_matmul"] == 0          # nothing launched


def test_plain_takes_any_leading_shape():
    from deeplearning4j_tpu_torch.kernels import measure
    x, w, s = measure.int8_matmul_case(torch.device("cpu"), 12, 32, 16)
    got = im.int8_matmul(x.view(3, 4, 32), w, s)
    assert got.shape == (3, 4, 16)
    assert torch.equal(got.reshape(12, 16), im.int8_matmul(x, w, s))


@pytest.mark.parametrize("bad,match", [
    (dict(w=torch.zeros(32, 16, dtype=torch.int8)), "do not match"),
    (dict(scale=torch.zeros(5)), "do not match"),
    (dict(w=torch.zeros(16, 8)), "int8"),
    (dict(x=torch.zeros(16)[None, :, None]), "do not match")])
def test_wrapper_refuses_mismatched_inputs(bad, match):
    args = dict(x=torch.zeros(4, 16), w=torch.zeros(16, 8, dtype=torch.int8),
                scale=torch.ones(8))
    args.update(bad)
    with pytest.raises(ValueError, match=match):
        im.int8_matmul(**args)


def test_launch_passes_the_geometry_layout_and_row_stride(monkeypatch):
    """``_launch`` hands the C entry M, N, K, x's row stride, the layout
    and the stream; a view whose rows are strided keeps its stride, and
    the output has x's leading shape."""
    calls = []

    class Entry:
        def __call__(self, *a):
            calls.append(a)
            return 0

    lib = types.SimpleNamespace(**{im.ENTRY: Entry()})
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 7, raising=False)
    base = torch.zeros(5, 48)
    x = base[:, :32]                          # rows 48 floats apart
    w = torch.zeros(32, 24, dtype=torch.int8)
    y = im._launch(x, w, torch.ones(24), False, lib=lib)
    wt = torch.zeros(40, 32, dtype=torch.int8)
    yt = im._launch(x.view(5, 1, 32), wt, torch.ones(32), True, lib=lib)
    names = [n for n, _ in im.ARGTYPES]
    a, b = (dict(zip(names, c)) for c in calls)
    assert (a["M"], a["N"], a["K"], a["sxm"], a["layout"]) == (5, 24, 32, 48, 0)
    assert (b["M"], b["N"], b["K"], b["layout"]) == (5, 40, 32, 1)
    assert a["x"] == x.data_ptr() and a["stream"] == 7
    assert y.shape == (5, 24) and yt.shape == (5, 1, 40)
    # the geometry the C entry picks: 8 ranks a 64-column tile of 8, 16,
    # 32 or 64 rows (the MMA's n) by M
    assert im.grid_blocks(5, 24) == 8
    assert im.grid_blocks(8, 1536) == 24 * 8
    assert im.grid_blocks(64, 4608) == 72 * 8
    assert im.grid_blocks(65, 4608) == 72 * 2 * 8
    assert im.grid_blocks(512, 32768) == 512 * 8 * 2
    assert im.grid_blocks(8, 32768) == 512 * 2


# ----------------------------------------------------------------------
# the int8 decode functions against the JAX package's
def _qparams(jcfg, pcfg, jsd, psd):
    names = jgpt.gpt_param_names(jcfg)
    return (jgpt.gpt_quantize_params({n: jsd._arrays[n] for n in names},
                                     jcfg),
            pgpt.gpt_quantize_params({n: psd.get_arr_for_var(n)
                                      for n in names}, pcfg))


def test_int8_dense_prefill_and_decode_match_jax(pair):
    jcfg, pcfg, jsd, psd = pair
    jp, pp = _qparams(jcfg, pcfg, jsd, psd)
    jf = jgpt.gpt_decode_fns(jcfg, quantize_weights=True)
    pf = pgpt.gpt_decode_fns(pcfg, quantize_weights=True)
    msl = jcfg.max_seq_len
    shape = (jcfg.num_layers, 3, jcfg.num_heads, msl, jcfg.head_size)
    jkc = jvc = jnp.zeros(shape, jnp.float32)
    pkc, pvc = torch.zeros(shape), torch.zeros(shape)
    rng = np.random.default_rng(1)
    for slot, L in ((0, 5), (2, 9)):
        tokens = np.zeros(16, np.int32)
        tokens[:L] = rng.integers(0, jcfg.vocab_size, L)
        io = {"tokens": tokens, "length": np.int32(L), "slot": np.int32(slot)}
        jkc, jvc, jn, jl = jf[0](jp, jkc, jvc, io)
        with torch.inference_mode():
            pkc, pvc, pn, pl = pf[0](pp, pkc, pvc, io)
        _close(pl, np.asarray(jl))
        assert int(pn) == int(jn)
    io = {"tokens": np.array([3, 0, 7], np.int32),
          "positions": np.array([5, 0, 9], np.int32),
          "active": np.array([True, False, True])}
    jkc, jvc, jn, jl = jf[1](jp, jkc, jvc, io)
    with torch.inference_mode():
        pkc, pvc, pn, pl = pf[1](pp, pkc, pvc, io)
    act = io["active"]
    _close(pl[act], np.asarray(jl)[act])
    np.testing.assert_array_equal(pn.numpy()[act], np.asarray(jn)[act])
    _close(pkc, np.asarray(jkc))


def test_int8_paged_prefill_and_decode_match_jax(pair):
    jcfg, pcfg, jsd, psd = pair
    jp, pp = _qparams(jcfg, pcfg, jsd, psd)
    bs = 8
    maxb = jcfg.max_seq_len // bs
    jf = jgpt.gpt_paged_decode_fns(jcfg, bs, maxb, quantize_weights=True)
    pf = pgpt.gpt_paged_decode_fns(pcfg, bs, maxb, quantize_weights=True)
    shape = (jcfg.num_layers, 1 + 2 * maxb, jcfg.num_heads, bs,
             jcfg.head_size)
    jkc = jvc = jnp.zeros(shape, jnp.float32)
    pkc, pvc = torch.zeros(shape), torch.zeros(shape)
    tables = (1 + np.arange(2)[:, None] * maxb
              + np.arange(maxb)[None, :]).astype(np.int32)
    rng = np.random.default_rng(2)
    pos = []
    for lane, L in ((0, 11), (1, 4)):
        tokens = np.zeros(16, np.int32)
        tokens[:L] = rng.integers(0, jcfg.vocab_size, L)
        io = {"tokens": tokens, "length": np.int32(L), "hist": np.int32(0),
              "table": tables[lane]}
        jkc, jvc, jn, jl = jf[0](jp, jkc, jvc, io)
        with torch.inference_mode():
            pkc, pvc, pn, pl = pf[0](pp, pkc, pvc, io)
        _close(pl, np.asarray(jl))
        assert int(pn) == int(jn)
        pos.append(L)
    pos = np.array(pos, np.int32)
    io = {"tokens": np.array([5, 9], np.int32), "positions": pos,
          "active": np.array([True, True]), "tables": tables,
          "write_block": tables[np.arange(2), pos // bs],
          "write_off": (pos % bs).astype(np.int32)}
    jkc, jvc, jn, jl = jf[1](jp, jkc, jvc, io)
    with torch.inference_mode():
        pkc, pvc, pn, pl = pf[1](pp, pkc, pvc, io)
    _close(pl, np.asarray(jl))
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))


@pytest.mark.parametrize("paged", [False, True])
def test_int8_dispatch_is_4L_plus_1_launches(monkeypatch, paged):
    """With the card's launch stubbed (the checks pass as for a CUDA
    tensor, the launch returns the plain product), an int8 prefill,
    decode or verify dispatch launches ``int8_matmul`` 4 times a layer and
    once for the tied logits, and the embedding take launches nothing."""
    cfg = pgpt.GPT_TINY
    monkeypatch.setattr(im, "_check", lambda *a: types.SimpleNamespace(
        type="cuda"))
    monkeypatch.setattr(im, "_launch", lambda x, w, s, tr, **kw:
                        im.int8_matmul_plain(x, w, s, tr))
    sd = pgpt.build_gpt(cfg, batch=2, seq_len=8, seed=0, device="cpu")
    if paged:
        spec = pgpt.gpt_paged_spec(sd, cfg, quantize_weights=True)
        fns = spec.make_fns(16, 4)
        shape = spec.kv_shape(9, 16)
        ios = [{"tokens": np.zeros(8, np.int32), "length": np.int32(5),
                "hist": np.int32(0), "table": np.arange(1, 5, dtype=np.int32)},
               {"tokens": np.zeros(2, np.int32),
                "positions": np.array([5, 0], np.int32),
                "active": np.array([True, False]),
                "tables": np.arange(1, 9, dtype=np.int32).reshape(2, 4),
                "write_block": np.array([1, 0], np.int32),
                "write_off": np.array([5, 0], np.int32)},
               {"tokens": np.zeros((2, 3), np.int32),
                "positions": np.array([6, 0], np.int32),
                "active": np.array([True, False]),
                "tables": np.arange(1, 9, dtype=np.int32).reshape(2, 4),
                "write_block": np.array([[1, 1, 1], [-1, -1, -1]], np.int32),
                "write_off": np.array([[6, 7, 8], [0, 0, 0]], np.int32)}]
    else:
        spec = pgpt.gpt_generative_spec(sd, cfg, quantize_weights=True)
        fns = (spec.prefill, spec.decode, spec.verify)
        shape = spec.kv_shape(2, 64)
        ios = [{"tokens": np.zeros(8, np.int32), "length": np.int32(5),
                "slot": np.int32(0)},
               {"tokens": np.zeros(2, np.int32),
                "positions": np.array([5, 0], np.int32),
                "active": np.array([True, False])},
               {"tokens": np.zeros((2, 3), np.int32),
                "positions": np.array([6, 0], np.int32),
                "active": np.array([True, False])}]
    params = spec.params()
    kc, vc = torch.zeros(shape), torch.zeros(shape)
    for fn, io in zip(fns, ios):
        im.reset_launches()
        with torch.inference_mode():
            fn(params, kc, vc, io)
        assert im.LAUNCHES["int8_matmul"] == 4 * cfg.num_layers + 1


# ----------------------------------------------------------------------
# the CUDA source and its binding
def _c_entry_params():
    src = SRC.read_text()
    m = re.search(r'extern "C" int ' + im.ENTRY + r'\((.*?)\)\s*\{', src,
                  re.S)
    params = [p.strip() for p in m.group(1).split(",")]
    return [(" ".join(p.split()[:-1]), p.split()[-1]) for p in params]


@pytest.mark.parametrize("m,by", [(8, "bytes"), (64, "operations")])
def test_bound_splits_only_x(m, by):
    """The int8-weight bound takes only x split: the faster of 2 TF32
    passes and 3 bf16 passes (3 bf16 on an H100), never 3xTF32's rate;
    qkv is bound by its bytes at M = 8 and by its operations at M = 64."""
    from deeplearning4j_tpu_torch.kernels import measure
    name = "NVIDIA H100 80GB HBM3"
    ops, nbytes = measure.int8_matmul_bounds(m, 1536, 4608)
    assert ops == 2 * m * 1536 * 4608
    assert nbytes == 1536 * 4608 + 4 * (m * 1536 + m * 4608 + 4608)
    b = measure.int8_weight_bound(ops, nbytes, name)
    assert b["bf16x3_ms"] == pytest.approx(1e3 * ops / (989e12 / 3))
    assert b["tf32x2_ms"] == pytest.approx(1e3 * ops / (495e12 / 2))
    assert b["ops_ms"] == b["bf16x3_ms"]
    assert b["bound_ms"] == max(b["bytes_ms"], b["ops_ms"])
    assert b["bound_by"] == by
    assert b["ops_ms"] < measure.two_rate_bound(ops, nbytes, name)[
        "tf32x3_ms"]


def test_ctypes_declaration_matches_the_c_entry():
    c_types = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
               "int64_t": ctypes.c_int64, "int": ctypes.c_int}
    params = _c_entry_params()
    assert [n for _, n in params] == [n for n, _ in im.ARGTYPES]
    assert [c_types[t] for t, _ in params] == [t for _, t in im.ARGTYPES]
    assert re.findall(r'extern "C" int (\w+)\(', SRC.read_text()) == \
        [im.ENTRY]


def test_loading_the_library_declares_the_entry(monkeypatch):
    class Entry:
        argtypes = None
        restype = ctypes.c_int

    lib = types.SimpleNamespace(dl4j_int8_matmul=Entry())
    monkeypatch.setattr(_cuda, "load", lambda name: lib)
    assert im._lib() is lib
    assert lib.dl4j_int8_matmul.argtypes == [t for _, t in im.ARGTYPES]


def test_nvcc_command_builds_the_source_for_sm90a():
    out = _cuda.library_path("int8_matmul")
    cmd = _cuda.build_command("int8_matmul", out, "nvcc")
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert cmd[-1] == str(SRC)
    assert re.fullmatch(r"libint8_matmul-[0-9a-f]{16}\.so",
                        pathlib.Path(out).name)


def _design(code):
    """The design's text: namespace i8mm and its entry."""
    return code[code.index("namespace i8mm {"):]


def test_source_is_self_contained_and_sums_in_a_fixed_order():
    """The source includes only the CUDA runtime and driver types, bf16,
    stdint, the C++ library and the port's own header of Hopper primitives
    (no library kernel: no cuBLAS, CUTLASS or PyTorch header) and has no
    atomics. The design
    multiplies on wgmma (bf16 x bf16 into float32, A, the widened payload,
    from registers) at n = 8, 16, 32 and 64, takes a weight tile as one TMA
    box, cuts x into three bf16 pieces and sums in one order set by the
    weight's shape alone: a cluster of 8 ranks each an eighth of the
    64-deep K tiles (a range free of M), or one rank where the weight has
    many column tiles, the tiles in order, each tile's k16 steps as x_hi,
    x_mid, x_lo into a fresh partial added with a rounded add, the
    partials in rank order, then s[n]."""
    code = "\n".join(line.split("//")[0] for line in
                     SRC.read_text().splitlines())
    assert sorted(re.findall(r"#include <([\w/.]+)>", code)) == [
        "cuda.h", "cuda_bf16.h", "cuda_runtime.h", "list", "map", "mutex",
        "set", "stdint.h", "tuple"]
    assert re.findall(r'#include "(\S+)"', code) == ["sm90.cuh"]
    for word in ("cublas", "cutlass", "torch", "atomic", "mma.sync"):
        assert word not in code.lower()
    new = _design(code)
    for n in (8, 16, 32, 64):
        assert (f"wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16"
                in new)
    assert "__cluster_dims__(RANKS, 1, 1)" in new
    # the K split by the weight's shape: 8 ranks below MANY_TILES column
    # tiles, 2 from there on, the same for every M
    assert f"constexpr int kManyTiles = {im.MANY_TILES};" in new
    assert ("inline int ranks_for(int N) { return (N + 63) / 64 >= kManyTiles"
            " ? 2 : 8; }") in new
    assert ("return ranks_for(a.N) == 2 ? launch<LAYOUT, BM, 2>(a, st) : "
            "launch<LAYOUT, BM, 8>(a, st);") in new
    assert [im.ranks(n) for n in (1536, 4608, 6144, 16320, 16384, 32768)] \
        == [8, 8, 8, 8, 2, 2]
    assert "constexpr int kBN = 64;" in new and im.TILE_N == 64
    assert "constexpr int kBK = 64;" in new and im.TILE_K == 64
    body = new[new.index("__device__ __forceinline__ void rank_tiles"):]
    body = body[:body.index("}") + 1]
    assert "M" not in body.replace("min(", "")     # the split: K alone
    # the pieces: the shared header's cut, each difference exact, hi, mid,
    # lo in that order
    assert "split3(v.x, v.y, p01);" in new and "split3(v.z, v.w, p23);" in new
    header = (SRC.parent / "sm90.cuh").read_text()
    assert ("const float ra = __fsub_rn(a, bf_lo(pc[0])), rb = "
            "__fsub_rn(b, bf_hi(pc[0]));") in header
    assert "pc[1] = bf16x2(ra, rb);" in header
    assert ("pc[2] = bf16x2(__fsub_rn(ra, bf_lo(pc[1])), "
            "__fsub_rn(rb, bf_hi(pc[1])));") in header
    # the weight: one TMA box a tile, its map encoded once a weight
    assert "cp.async.bulk.tensor.2d.shared::cluster.global" in new
    assert "CU_TENSOR_MAP_DATA_TYPE_UINT8" in new
    # the maps kept are bounded: the least recently used goes first
    assert "constexpr size_t kMaxMaps = 512;" in new
    assert "used.splice(used.begin(), used, it->second);" in new
    assert ("if (used.size() > kMaxMaps) {\n    maps.erase(used.back().first);"
            "\n    used.pop_back();") in new
    steps = new[new.index("for (int kk = 0; kk < 4; ++kk)\n#pragma unroll\n"
                          "      for (int p = 0; p < kPieces; ++p)"):]
    assert "desc_b(xs + p * BM * 128, c * NW, kk), kk + p > 0);" in \
        steps[:steps.index("wgmma_commit();")]
    assert "acc[e] = __fadd_rn(acc[e], part[e]);" in new
    assert "for (int r = 1; r < RANKS; ++r) sum = __fadd_rn(sum, " \
        "pr[r * 8 * BM]);" in new
    assert "if (LAYOUT == 0) sum = __fmul_rn(sum, __ldg(a.s + n));" in new
    assert ("v = make_float4(__fmul_rn(v.x, sk.x), __fmul_rn(v.y, sk.y), "
            "__fmul_rn(v.z, sk.z),") in new
    # rows a tile by M, as tile_rows reads them
    picks = re.findall(r"if \(a\.M <= (\d+)\) return launch_r<LAYOUT, (\d+)>",
                       new)
    assert [(int(m), int(r)) for m, r in picks] == [(8, 8), (16, 16),
                                                    (32, 32)]
    assert "return launch_r<LAYOUT, 64>(a, st);" in new
    assert [im.tile_rows(m) for m in (1, 8, 9, 16, 17, 32, 33, 64, 65,
                                      512)] == [8, 8, 16, 16, 32, 32, 64, 64,
                                                64, 64]


# ----------------------------------------------------------------------
# the kernel's numerics, emulated on the CPU: x in three bf16 pieces
def _pieces(x, n=3):
    """x cut as the kernel cuts it: x_hi = bf16(x), x_mid = bf16(x -
    x_hi), x_lo = bf16(x - x_hi - x_mid), each difference exact in float32;
    the first ``n`` of them."""
    out, r = [], x
    for _ in range(n):
        p = r.to(torch.bfloat16).float()
        out.append(p)
        r = r - p
    return out


def _emulate(x, w, s, transposed, pieces=3):
    """The kernel's order in float32: the 64-deep K tiles cut in the rank
    ranges the weight's shape sets (``im.ranks``), each tile's 16-deep
    steps as the pieces (hi, mid, lo) times the exact bf16 payload into a
    fresh partial, added to the rank's sum; the rank sums in rank order;
    then s[n] (layout 0)."""
    xs = x * s if transposed else x
    wk = (w.t() if transposed else w).float()                  # [K, N]
    k = x.shape[1]
    nr = im.ranks(wk.shape[1])
    kt = -(-k // 64)
    per = -(-kt // nr)
    parts = _pieces(xs, pieces)
    ranks = []
    for r in range(nr):
        acc = torch.zeros(x.shape[0], wk.shape[1])
        for t in range(min(r * per, kt), min(r * per + per, kt)):
            part = torch.zeros_like(acc)
            for k0 in range(64 * t, min(64 * t + 64, k), 16):
                for p in parts:
                    part = part + p[:, k0:k0 + 16] @ wk[k0:k0 + 16]
            acc = acc + part
        ranks.append(acc)
    y = ranks[0]
    for a in ranks[1:]:
        y = y + a
    return y if transposed else y * s


def test_the_pieces_add_up_to_x_exactly():
    """x_hi + x_mid + x_lo is x, bit for bit, over float32's normal range
    and both signs; two pieces are not."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=4096) * 2.0 ** rng.integers(
        -100, 100, size=4096)).astype(np.float32))
    hi, mid, lo = _pieces(x)
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())
    assert not torch.equal(hi.double() + mid.double(), x.double())


@pytest.mark.parametrize("k,n,transposed", [
    (1536, 4608, False), (1536, 1536, False), (1536, 6144, False),
    (6144, 1536, False), (1536, 32768, True)])
def test_piece_split_meets_the_gate_at_every_gpt_medium_shape(k, n,
                                                              transposed):
    """The kernel's numerics (three bf16 pieces, the kernel's sum order in
    float32) lie within INT8_TOL (1e-5 of each output's absolute terms)
    of the float64 product at GPT-medium's (K, N); one piece (x_hi alone)
    does not."""
    from deeplearning4j_tpu_torch.kernels import measure
    x, w, s = measure.int8_matmul_case(torch.device("cpu"), 3, k, n,
                                       transposed, seed=k + n)
    want = im.int8_matmul_plain(x.double(), w, s.double(), transposed)
    tol = 1e-5 * im.abs_terms(x, w, s, transposed)
    for pieces, ok in ((3, True), (1, False)):
        got = _emulate(x, w, s, transposed, pieces).double()
        assert bool(((got - want).abs() <= tol).all()) is ok, pieces
