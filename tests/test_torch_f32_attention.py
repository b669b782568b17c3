"""The float32 attention library (``csrc/attention_f32.cu`` behind
``kernels/attention_f32.py``), on the CPU: its binding held to the C
source, the routing of ``attention_fwd`` and ``paged_prefill_attention``
by dtype (with the launches stubbed), the work split the wrapper hands the
kernels, the prefill function's plain version against the JAX package's
prefill expression, and the bound helpers at the two serving shapes.

The kernels run only on a card (``tests/test_torch_card.py``,
``chip_smoke.py``). Tolerances: the plain prefill against the JAX
expression at 1e-6 of the largest magnitude (float32 sums in another
order); the bound helpers to 1e-9 relative (the same arithmetic).
"""
import contextlib
import ctypes
import math
import pathlib
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.kernels import _cuda
from deeplearning4j_tpu_torch.kernels import attention as at
from deeplearning4j_tpu_torch.kernels import attention_f32 as af
from deeplearning4j_tpu_torch.kernels import measure
from deeplearning4j_tpu_torch.kernels import paged_attention as pa

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "deeplearning4j_tpu_torch" / "csrc" / "attention_f32.cu"
H100 = "NVIDIA H100 80GB HBM3"


def _code():
    """The source with its comments removed."""
    return "\n".join(line.split("//")[0]
                     for line in SRC.read_text().splitlines())


def _c_params(entry):
    m = re.search(r'extern "C" int ' + entry + r'\((.*?)\)\s*\{',
                  SRC.read_text(), re.S)
    params = [p.strip() for p in m.group(1).split(",")]
    return [(" ".join(p.split()[:-1]), p.split()[-1]) for p in params]


C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "int64_t": ctypes.c_int64, "int": ctypes.c_int,
           "double": ctypes.c_double, "int*": ctypes.c_void_p}


@pytest.mark.parametrize("entry", sorted(af.ENTRIES))
def test_ctypes_declarations_match_the_c_entries(entry):
    params = _c_params(entry)
    argtypes = af.ENTRIES[entry]
    assert [n for _, n in params] == [n for n, _ in argtypes]
    assert [C_TYPES[t] for t, _ in params] == [t for _, t in argtypes]
    # every pointer and the stream go as c_void_p, never as a 32-bit int
    pointers = [n for t, n in params if t.endswith("*")]
    if entry.endswith("blocks_per_sm"):
        assert pointers == ["blocks"]
    else:
        assert pointers[-1] == "stream" and "part" in pointers


def test_the_source_defines_exactly_the_declared_entries():
    assert sorted(re.findall(r'extern "C" int (dl4j_\w+)\(', _code())) == \
        sorted(af.ENTRIES)


def test_loading_the_library_declares_both_entries(monkeypatch):
    class Entry:
        argtypes = None
        restype = ctypes.c_int

    lib = types.SimpleNamespace(**{name: Entry() for name in af.ENTRIES})
    loaded = []
    monkeypatch.setattr(_cuda, "load", lambda name: loaded.append(name)
                        or lib)
    assert af._lib() is lib and loaded == ["attention_f32"]
    for name, argtypes in af.ENTRIES.items():
        fn = getattr(lib, name)
        assert fn.argtypes == [t for _, t in argtypes]
        assert fn.restype is ctypes.c_int


def test_nvcc_command_builds_the_f32_source_for_sm90a():
    out = _cuda.library_path("attention_f32")
    cmd = _cuda.build_command("attention_f32", out, "nvcc")
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert cmd[-1] == str(SRC)
    assert pathlib.Path(out).parent == \
        ROOT / "deeplearning4j_tpu_torch" / "_build" / "cuda"
    assert re.fullmatch(r"libattention_f32-[0-9a-f]{16}\.so",
                        pathlib.Path(out).name)


def test_source_multiplies_in_3xtf32_on_mma_sync_with_no_atomics():
    """Both entries run one tile engine whose products are tf32 mma.sync,
    three to a product (lo.hi, hi.lo, hi.hi), fed by cp.async; no sum
    (nothing at all) is atomic, and no library is called."""
    code = _code()
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in code
    assert "cp.async.cg.shared.global" in code
    mma3 = re.search(r"void mma3\(.*?\{(.*?)\n\}", code, re.S).group(1)
    assert re.findall(r"mma\(c, (\w+), (\w+)\)", mma3) == [
        ("al", "bh"), ("ah", "bl"), ("ah", "bh")]
    assert "atomic" not in code.lower()
    for lib in ("cublas", "cudnn", "cutlass", "#include <torch"):
        assert lib not in code.lower()
    # one self-contained source: only the toolkit's and the C++ standard
    # library's headers (the per-device attribute record: mutex, set)
    assert set(re.findall(r"#include <(\S+)>", code)) == {
        "cuda_runtime.h", "math.h", "stdint.h", "mutex", "set"}
    assert '#include "' not in code
    # both entries launch the same two kernels, dense and paged forms
    assert "launch_d<false>" in code and "launch_d<true>" in code


def test_shared_memory_attribute_is_raised_on_each_device():
    """A kernel's attributes belong to each device's context: the main
    kernel's shared memory is raised once per device (keyed by
    ``cudaGetDevice``, under a lock), and the occupancy query goes through
    the same path, so a second card neither fails the launch nor reads 0
    blocks an SM."""
    code = _code()
    body = re.search(r"cudaError_t configure\(\) \{(.*?)\n\}", code,
                     re.S).group(1)
    assert "cudaGetDevice(&dev)" in body and "raised.count(dev)" in body
    assert "std::lock_guard<std::mutex>" in body
    assert "static const cudaError_t" not in body
    occ = re.search(r"int occupancy\(int\* blocks\) \{(.*?)\n\}", code,
                    re.S).group(1)
    assert "configure<D, PAGED>()" in occ


def test_slots_refuse_a_kernel_that_fits_no_block(monkeypatch):
    monkeypatch.setattr(af, "blocks_per_sm", lambda d, paged: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda index: contextlib.
                        nullcontext())
    with pytest.raises(RuntimeError, match="fits no block"):
        af.slots.__wrapped__(0, 128, True)


def test_split_constants_round_to_tf32():
    """hi = (bits + 0x1000) & 0xffffe000 rounds the mantissa to 10 bits,
    to nearest (ties away from 0); x - hi is exact and at most half of
    hi's last place."""
    code = _code()
    assert "(__float_as_uint(x) + 0x1000u) & 0xffffe000u" in code
    x = np.random.default_rng(0).normal(size=10000).astype(np.float32)
    hi = ((x.view(np.uint32) + np.uint32(0x1000))
          & np.uint32(0xffffe000)).view(np.float32)
    lo = x - hi
    assert np.all(np.abs(lo) <= np.abs(x) * 2.0 ** -11)
    assert np.all((hi.view(np.uint32) & np.uint32(0x1fff)) == 0)
    assert np.array_equal(hi.astype(np.float64) + lo, x.astype(np.float64))


# ----------------------------------------------------------------------
# routing by dtype, with the launches stubbed
def _route_attention_fwd(monkeypatch, dtype):
    calls = []
    monkeypatch.setattr(at, "_PLAIN_DEVICES", ())
    monkeypatch.setattr(at, "_check", lambda q, k, v: q.device)
    monkeypatch.setattr(af, "attention_fwd_f32", lambda *a: calls.append(
        "dl4j_attention_fwd_f32") or ("o", "stats"))
    monkeypatch.setattr(at, "_launch", lambda entry, *a, **kw: calls.append(
        entry))
    q = torch.zeros(1, 2, 8, 16, dtype=dtype)
    at.attention_fwd(q, q, q, True)
    return calls


@pytest.mark.parametrize("dtype,entry", [
    (torch.float32, "dl4j_attention_fwd_f32"),
    (torch.float64, "dl4j_attention_fwd"),
    (torch.bfloat16, "dl4j_attention_fwd")])
def test_attention_fwd_routes_float32_to_the_tensor_core_kernel(
        monkeypatch, dtype, entry):
    assert _route_attention_fwd(monkeypatch, dtype) == [entry]


@pytest.mark.parametrize("dtype,entry", [
    (torch.float32, "dl4j_paged_prefill_f32"),
    (torch.float64, "dl4j_paged_attention")])
def test_paged_prefill_routes_float32_to_the_tensor_core_kernel(
        monkeypatch, dtype, entry):
    calls = []
    monkeypatch.setattr(pa, "_check", lambda *a: types.SimpleNamespace(
        type="cuda"))
    monkeypatch.setattr(af, "paged_prefill_f32", lambda *a: calls.append(
        ("dl4j_paged_prefill_f32", a[4:])))
    monkeypatch.setattr(pa, "paged_attention", lambda q, kc, vc, tables,
                        lane, kmax, *scales: calls.append((
                            "dl4j_paged_attention", (tuple(tables.shape),
                                                     lane.tolist()))))
    q = torch.zeros(3, 2, 16, dtype=dtype)
    kc = torch.zeros(4, 2, 8, 16, dtype=dtype)
    table = torch.tensor([1, 2], dtype=torch.int32)
    kmax = torch.tensor([3, 4, 9], dtype=torch.int32)
    pa.paged_prefill_attention(q, kc, kc, table, kmax, [3, 4, 9])
    assert [c[0] for c in calls] == [entry]
    if dtype == torch.float64:      # every row in lane 0 of a one-row table
        assert calls[0][1] == ((1, 2), [0, 0, 0])
    else:                           # kmax and the host's copy passed on
        assert calls[0][1][1] == [3, 4, 9]


@pytest.mark.parametrize("table,kmax,kmax_host,match", [
    (torch.zeros(1, 2, dtype=torch.int32), torch.zeros(2, dtype=torch.int32),
     [0, 0], "MAXB"),
    (torch.zeros(2, dtype=torch.int32), torch.zeros(3, dtype=torch.int32),
     [0, 0], "MAXB"),
    (torch.zeros(2, dtype=torch.int32), torch.zeros(2, dtype=torch.int32),
     [0, 0, 0], "kmax_host")])
def test_paged_prefill_refuses_a_bad_table_or_kmax(table, kmax, kmax_host,
                                                   match):
    with pytest.raises(ValueError, match=match):
        pa.paged_prefill_attention(
            torch.zeros(2, 2, 16), torch.zeros(3, 2, 8, 16),
            torch.zeros(3, 2, 8, 16), table, kmax, kmax_host)


def test_cpu_calls_launch_nothing():
    af.reset_launches()
    q = torch.randn(1, 2, 70, 16)
    at.attention_fwd(q, q, q, True)
    args = measure.paged_prefill_case("cpu", 15, 65, 60, 2, 16, 8,
                                      torch.float32)
    pa.paged_prefill_attention(args[0], args[1], args[2], args[3][0],
                               args[5], args[5].numpy())
    assert af.LAUNCHES == {n: 0 for n in af.LAUNCHES}


# ----------------------------------------------------------------------
# what the wrappers hand the C entries
class _FakeLib:
    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        if not name.startswith("dl4j_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls[name] = args
            return 0
        return entry


def test_launch_fwd_passes_shapes_strides_and_split():
    qkv = torch.zeros(2, 40, 3, 3 * 32).permute(0, 2, 1, 3)
    q, k, v = torch.split(qkv, 32, dim=3)
    out, stats = torch.zeros(2, 3, 40, 32), torch.zeros(2, 3, 40, 2)
    part = torch.zeros(7)
    lib = _FakeLib()
    af.launch_fwd(q, k, v, out, stats, part, 0.125, True, 128, 99, lib=lib)
    args = dict(zip([n for n, _ in af.FWD_ARGTYPES],
                    lib.calls["dl4j_attention_fwd_f32"]))
    assert args["part_floats"] == 7 and args["chunk"] == 128
    assert (args["B"], args["H"], args["Sq"], args["Sk"], args["D"]) == (
        2, 3, 40, 40, 32)
    assert (args["sqb"], args["sqh"], args["sqs"]) == q.stride()[:3] == (
        40 * 3 * 96, 96, 3 * 96)
    assert (args["skb"], args["skh"], args["sks"]) == k.stride()[:3]
    assert args["q"] == q.data_ptr() and args["k"] == k.data_ptr()
    assert args["scale"] == 0.125 and args["causal"] == 1
    assert args["stream"] == 99


def test_launch_prefill_passes_the_cache_geometry():
    q = torch.zeros(5, 3, 97)[..., :32]
    kc = torch.zeros(6, 3, 16, 32)
    table = torch.zeros(4, dtype=torch.int32)
    kmax = torch.zeros(5, dtype=torch.int32)
    lib = _FakeLib()
    af.launch_prefill(q, kc, kc, table, kmax, torch.zeros(5, 3, 32),
                      torch.zeros(1), 0.5, 64, 7, lib=lib)
    args = dict(zip([n for n, _ in af.PREFILL_ARGTYPES],
                    lib.calls["dl4j_paged_prefill_f32"]))
    assert (args["N"], args["A"], args["D"], args["BS"], args["MAXB"]) == (
        5, 3, 32, 16, 4)
    assert (args["sqn"], args["sqa"]) == (3 * 97, 97)
    assert (args["skb"], args["ska"], args["skt"]) == (3 * 16 * 32, 16 * 32,
                                                       32)
    assert args["chunk"] == 64 and args["stream"] == 7


@pytest.mark.parametrize("view,copies", [
    ("contiguous", 0), ("split", 0), ("rows_65_floats", 1),
    ("offset_1_float", 1)])
def test_views_off_16_bytes_are_copied_and_counted(view, copies):
    if view == "contiguous":
        t = torch.randn(1, 2, 8, 64)
    elif view == "split":
        t = torch.split(torch.randn(1, 8, 2, 192).permute(0, 2, 1, 3), 64,
                        dim=3)[1]
    elif view == "rows_65_floats":
        t = torch.randn(1, 2, 8, 65)[..., :64]
    else:
        t = torch.randn(1 * 2 * 8 * 64 + 1)[1:].view(1, 2, 8, 64)
    af.reset_launches()
    (got,) = _cuda.copy_unaligned((t,), af.ALIGN_COPIES, "attention_fwd_f32")
    assert af.ALIGN_COPIES["attention_fwd_f32"] == copies
    assert (got is not t) == bool(copies) and torch.equal(got, t)
    assert _cuda.rows_aligned([got])


# ----------------------------------------------------------------------
# the work split
def _visible_keys(sq, sk, causal):
    """Brute force: per 64-row tile, one past its last key a row sees
    (every key for a fully masked row)."""
    off = sk - sq
    out = []
    for q0 in range(0, sq, 64):
        rows = range(q0, min(q0 + 64, sq))
        if not causal or any(i + off < 0 for i in rows):
            out.append(sk)
        else:
            out.append(max(min(i + off, sk - 1) for i in rows) + 1)
    return out


@pytest.mark.parametrize("sq,sk,causal", [
    (512, 512, True), (63, 63, True), (65, 65, True), (129, 129, True),
    (70, 333, True), (333, 70, True), (333, 70, False), (1, 1, True)])
def test_dense_tile_keys_are_what_each_tile_sees(sq, sk, causal):
    assert af.dense_tile_keys(sq, sk, causal) == _visible_keys(sq, sk,
                                                               causal)


def test_paged_tile_keys_take_each_tiles_largest_last_key():
    kmax = np.array([5] * 64 + [900, 2, -1] + [-1] * 61 + [-1])
    assert af.paged_tile_keys(kmax, 768) == [6, 768, 0]


def test_chunks_fill_the_card_about_once_at_the_serving_shapes():
    """132 SMs, two blocks each (264 slots): the dense prefill (432 units
    of 64 keys over 12 heads) takes items of 128 keys, 240 of them; the
    paged prefill after 256 cached keys (816 units) items of 256 keys, 240
    of them."""
    dense = af.dense_tile_keys(512, 512, True)
    assert af.chunk_keys(dense, 12, 264) == 128
    paged = af.paged_tile_keys(256 + np.arange(512), 1024)
    assert af.chunk_keys(paged, 12, 264) == 256
    items = sum(-(-k // 256) for k in paged) * 12
    assert items == 240 <= 2 * 132
    # a small call is never cut
    assert af.chunk_keys([16], 12, 264) == 64
    assert af.partial_floats(12, 16, 64, 64, 128) == 0
    assert af.partial_floats(12, 512, 1024, 256, 128) == \
        12 * 8 * 4 * 64 * 130


def _stub_launches(monkeypatch):
    """The wrappers on CPU tensors with the card's parts stubbed: 264
    slots (132 SMs, two blocks each), the launches recorded (their
    chunk), nothing run."""
    chunks = []
    monkeypatch.setattr(af, "slots", lambda *a: 264)
    monkeypatch.setattr(af, "_stream", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.
                        nullcontext())
    monkeypatch.setattr(af, "launch_fwd", lambda *a: chunks.append(a[8]))
    monkeypatch.setattr(af, "launch_prefill", lambda *a: chunks.append(a[8]))
    return chunks


@pytest.mark.parametrize("shape,combines", [
    ((1, 12, 512, 128), 1),     # the dense prefill: tiles cut into items
    ((1, 2, 16, 16), 0)])       # one item a tile: no combining launch
def test_dense_call_counts_its_combining_launch(monkeypatch, shape,
                                                combines):
    chunks = _stub_launches(monkeypatch)
    af.reset_launches()
    q = torch.zeros(shape)
    af.attention_fwd_f32(q, q, q, True, 0.125)
    assert chunks == [128 if combines else 64]
    assert af.LAUNCHES == {"attention_fwd_f32": 1, "paged_prefill_f32": 0,
                           "attention_f32_combine": combines}


@pytest.mark.parametrize("hist,rows,combines", [
    (256, 512, 1),     # the paged prefill's serving shape
    (0, 1, 0)])
def test_paged_call_counts_its_combining_launch(monkeypatch, hist, rows,
                                                combines):
    chunks = _stub_launches(monkeypatch)
    af.reset_launches()
    q, kc, vc, tables, _, kmax = measure.paged_prefill_case(
        "cpu", hist, rows, rows, 12, 128, 16, torch.float32)
    af.paged_prefill_f32(q, kc, vc, tables[0], kmax, kmax.numpy())
    reach = kc.shape[2] * tables.shape[1]
    assert (af.partial_floats(12, rows, reach, chunks[0], 128) > 0) == \
        bool(combines)
    assert af.LAUNCHES == {"attention_fwd_f32": 0, "paged_prefill_f32": 1,
                           "attention_f32_combine": combines}


# ----------------------------------------------------------------------
# the prefill function's plain version
def _jax_prefill_attention(q, kc, vc, table, hist, length):
    """zoo/gpt.py gpt_paged_decode_fns.prefill_fn :621-636 (q [Lb, A, D])."""
    lb, a, d = q.shape
    t = table.shape[0] * kc.shape[2]
    g = hist + jnp.arange(lb)
    cm = jnp.arange(t)[None, :] <= g[:, None]
    valid = jnp.arange(t) < hist + length
    ctx_k = jnp.transpose(kc[table], (1, 0, 2, 3)).reshape(a, t, d)
    ctx_v = jnp.transpose(vc[table], (1, 0, 2, 3)).reshape(a, t, d)
    ctx_k = jnp.where(valid[:, None], ctx_k, 0)
    ctx_v = jnp.where(valid[:, None], ctx_v, 0)
    scores = jnp.einsum("aqd,akd->aqk", jnp.transpose(q, (1, 0, 2)), ctx_k,
                        preferred_element_type=jnp.float32) / np.sqrt(d)
    scores = jnp.where(cm[None], scores, jnp.float32(-1e30))
    probs = jax.nn.softmax(scores, axis=-1).astype(ctx_v.dtype)
    return jnp.transpose(jnp.einsum("aqk,akd->aqd", probs, ctx_v),
                         (1, 0, 2))


@pytest.mark.parametrize("bs", [1, 5, 16])
@pytest.mark.parametrize("hist,length,lb", [(3, 9, 16), (11, 5, 8),
                                            (0, 1, 1)])
def test_plain_prefill_matches_the_jax_expression(bs, hist, length, lb):
    """Hist off a block edge, padded rows (a padded row stops at the last
    real row's key, as the server hands it over; only real rows compared),
    blocks of 1, 5 and 16 in a shuffled table with the null block and a
    NaN block unused."""
    rng = np.random.default_rng(bs * 100 + hist)
    maxb = -(-(hist + lb) // bs) + 1
    nb = maxb + 3
    kc, vc = (rng.normal(size=(nb, 2, bs, 16)).astype(np.float32)
              for _ in range(2))
    kc[0] = vc[0] = np.nan
    kc[nb - 1] = vc[nb - 1] = np.nan
    table = rng.permutation(np.arange(1, nb - 1))[:maxb].astype(np.int32)
    q = rng.normal(size=(lb, 2, 16)).astype(np.float32)
    want = np.asarray(_jax_prefill_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(table),
        hist, length))
    kmax = (hist + np.minimum(np.arange(lb), length - 1)).astype(np.int32)
    args = (torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
            torch.from_numpy(table), torch.from_numpy(kmax))
    got = pa.paged_prefill_attention(*args, kmax)
    plain = pa.paged_attention_plain(
        *args[:3], args[3][None], torch.zeros(lb, dtype=torch.int32),
        args[4])
    assert torch.equal(got, plain) and torch.equal(
        got, pa.paged_prefill_plain(*args))
    assert torch.isfinite(got).all()
    err = float(np.max(np.abs(got.numpy()[:length] - want[:length])))
    assert err <= 1e-6 * float(np.max(np.abs(want[:length])))


# ----------------------------------------------------------------------
# the bounds at the two serving shapes
def test_two_rate_bounds_at_the_serving_shapes():
    ops, nbytes = measure.attention_f32_bounds(1, 12, 512, 512, 128, True)
    assert ops == 4 * 128 * 12 * (512 * 513 // 2)
    assert nbytes == 4 * 12 * 128 * 4 * 512 + 8 * 12 * 512
    b = measure.two_rate_bound(ops, nbytes, H100)
    assert math.isclose(b["tf32x3_ms"], 1e3 * ops / (495e12 / 3),
                        rel_tol=1e-9)
    assert math.isclose(b["fma_ms"], 1e3 * ops / 67e12, rel_tol=1e-9)
    assert math.isclose(b["bytes_ms"], 1e3 * nbytes / 3.35e12, rel_tol=1e-9)
    assert b["bound_ms"] == b["tf32x3_ms"] and b["bound_by"] == "operations"
    assert 0.0048 < b["tf32x3_ms"] < 0.0050 and 0.0119 < b["fma_ms"] < 0.0121
    q, kc, vc, tables, lane, kmax = measure.paged_prefill_case(
        "cpu", 256, 512, 512, 12, 128, 16, torch.float32)
    ops, nbytes = measure.paged_bounds(q, kc, tables, lane, kmax)
    assert ops == 4 * 128 * 12 * sum(257 + j for j in range(512))
    b = measure.two_rate_bound(ops, nbytes, H100)
    assert 0.0097 < b["tf32x3_ms"] < 0.0099 and 0.0240 < b["fma_ms"] < 0.0242
    assert b["bound_by"] == "operations"
    assert measure.tf32x3_rate("NVIDIA H100 PCIe") == 378e12 / 3
