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


def _code(path=SRC):
    """The source (or the header ``path``) with its comments removed."""
    return "\n".join(line.split("//")[0]
                     for line in path.read_text().splitlines())


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


def _sections():
    """(the float engine's code, the int8 prefill's), comments removed: the
    int8 section runs from its stage count to the end of its kernel."""
    code = _code()
    a = code.index("constexpr int kI8Stages")
    b = code.index("\n}\n", code.index("prefill_i8_kernel(const F32Args a)"))
    return code[:a] + code[b + 3:], code[a:b + 3]


def test_source_multiplies_in_3xtf32_on_mma_sync_with_no_atomics():
    """The float engine (both entries over float32, the dense forward and
    the paged prefill over a float32 cache) multiplies in tf32 mma.sync,
    three to a product (lo.hi, hi.lo, hi.hi), fed by cp.async; the int8
    cache's kernel is not part of it (no int8 load, no wgmma, no bulk copy
    in the engine). No sum (nothing at all) is atomic, and no library is
    called."""
    code = _code()
    engine, i8 = _sections()
    # the split and the tf32 mma.sync live in the shared header
    header = _code(SRC.parent / "sm90.cuh")
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in header
    assert "mma3_tf32(" in engine and "tf32_split(" in engine
    assert "cp.async.cg.shared.global" in engine
    mma3 = re.search(r"void mma3_tf32\(.*?\{(.*?)\n\}", header,
                     re.S).group(1)
    assert re.findall(r"mma_tf32\(c, (\w+), (\w+)\)", mma3) == [
        ("al", "bh"), ("ah", "bl"), ("ah", "bh")]
    kernel = engine[engine.index("attn_f32_kernel(const F32Args a)"):]
    kernel = kernel[:kernel.index("\n}\n")]
    for other in ("int8_t", "ksc", "wgmma", "cp.async.bulk", "Q8"):
        assert other not in kernel, other
    assert "template <int D, bool PAGED>\n__global__ void __launch_bounds__(" \
        "kThreads, 2) attn_f32_kernel" in engine
    assert "mma.sync" not in i8 and "mma_tf32" not in i8
    assert "atomic" not in code.lower()
    for lib in ("cublas", "cudnn", "cutlass", "#include <torch"):
        assert lib not in code.lower()
    # only the toolkit's and the C++ standard library's headers (the
    # per-device attribute record: mutex, set) and the port's own header
    # of Hopper primitives
    assert set(re.findall(r"#include <(\S+)>", code)) == {
        "cuda_runtime.h", "math.h", "stdint.h", "mutex", "set"}
    assert re.findall(r'#include "(\S+)"', code) == ["sm90.cuh"]
    # both entries launch the float engine's two kernels, dense and paged
    # forms; the prefill's int8 cache its own kernel
    assert "launch_d<false>" in code and "launch_d<true>" in code
    assert "return k_scale != nullptr ? launch_i8_d(D, a, A, st) : " \
        "launch_d<true>(D, a, A, st);" in code


def test_int8_prefill_runs_bf16_wgmma_on_bulk_copied_int8_tiles():
    """The int8 cache's prefill kernel: int8 K/V tiles by cp.async.bulk on
    an mbarrier a stage (a run of a block's rows one copy), turned into
    bf16 tiles (exact) that wgmma reads K-major (K) and MN-major (V); q
    times s_k rounded once, then q's three bf16 pieces and P's three in
    the products; s_v in the epilogue; the float engine's 64 rows, work
    split and combining launch, and no mma.sync."""
    _, i8 = _sections()
    code = _code()
    header = _code(SRC.parent / "sm90.cuh")
    assert "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"\
        " [%0], [%1], %2, [%3];" in header
    assert "bulk_load(dk + r * D, kbase + blk * a.kb + off * a.ks, len * D, " \
        "bar);" in i8
    assert "const int len = runs ? min(a.BS - off, n - r) : 1;" in i8
    assert "mbar_wait(smem_u32(&full[s]), static_cast<uint32_t>((it / NS) " \
        "& 1));" in i8
    assert "x.x = __fmul_rn(x.x, __ldg(ks + c));" in i8
    assert i8.count("split3(") == 3   # q (2), P
    assert "Wgmma<BN>::ss(sc, desc_k<D, kBM>(qt + p * C::kQ, 0, kk), " \
        "desc_k<D, BN>(kt, 0, kk),\n                      p + kk > 0);" in i8
    assert "Wgmma<D>::rs(o, pa[p][kk], desc_mn<D, BN>(vt, kk));" in i8
    assert "i8x4_bf16(w.x, b[0], b[1]);" in i8
    assert i8.count("__ldg(vs + col)") == 2
    assert "fence.proxy.async.shared::cta" in i8
    for shape in ("m64n32k16", "m64n64k16", "m64n16k16", "m64n128k16"):
        assert f"wgmma.mma_async.sync.aligned.{shape}.f32.bf16.bf16" \
            in header
    assert "attn_f32_combine<D, true><<<" in code
    assert "for (int p = 0; p < 3; ++p)" in i8


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
    monkeypatch.setattr(af, "blocks_per_sm", lambda d, kind: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda index: contextlib.
                        nullcontext())
    with pytest.raises(RuntimeError, match="fits no block"):
        af.slots.__wrapped__(0, 128, "paged")


def test_split_constants_round_to_tf32():
    """hi = (bits + 0x1000) & 0xffffe000 rounds the mantissa to 10 bits,
    to nearest (ties away from 0); x - hi is exact and at most half of
    hi's last place (``tf32_split`` in the shared header)."""
    code = _code(SRC.parent / "sm90.cuh")
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


# ----------------------------------------------------------------------
# the int8 prefill's numerics, emulated on the CPU
def _bf16_pieces(x, n=3):
    """x cut as the kernel cuts it: hi = bf16(x), mid = bf16(x - hi), lo =
    bf16(x - hi - mid), each difference exact in float32; the first ``n``."""
    out, r = [], x
    for _ in range(n):
        p = r.to(torch.bfloat16).float()
        out.append(p)
        r = r - p
    return out


def _pieces_times(a, b, pieces):
    """sum over a's pieces (hi, mid, lo in turn) of piece @ b, in float32,
    16 deep at a time into one sum: the kernel's chain of k16 wgmmas."""
    acc = None
    for p in _bf16_pieces(a, pieces):
        for k0 in range(0, a.shape[-1], 16):
            part = p[..., k0:k0 + 16] @ b[..., k0:k0 + 16, :]
            acc = part if acc is None else acc + part
    return acc


def _emulate_prefill_i8(q, kc8, vc8, ks, vs, table, kmax, pieces=3):
    """prefill_i8_kernel's numerics in float32 for one lane's rows: S from
    q * s_k (rounded once) in pieces times the exact int8 K, the softmax
    in base 2 over each row's keys (-inf past its last), O from P in
    pieces times the exact int8 V, then O * s_v / l (0 for a row with no
    key)."""
    n, a, d = q.shape
    tab = table.long()
    k8, v8 = (c[tab].transpose(0, 1).reshape(a, -1, d).float()
              for c in (kc8, vc8))                             # [A, T, D]
    qs = (q * ks).transpose(0, 1)                              # [A, N, D]
    x = _pieces_times(qs, k8.transpose(1, 2), pieces) * (
        (1.0 / math.sqrt(d)) * 1.4426950408889634)
    keys = torch.arange(k8.shape[1])
    x = torch.where((keys[None, :] <= kmax.long()[:, None])[None], x,
                    -math.inf)
    m = x.amax(-1, keepdim=True)
    p = torch.exp2(x - torch.where(m == -math.inf, 0.0, m))
    lsum = p.sum(-1, keepdim=True)
    o = _pieces_times(p, v8, pieces) * vs[:, None, :]
    out = torch.where(lsum > 0, o / lsum, 0.0)
    return out.transpose(0, 1)


@pytest.mark.parametrize("hist,rows,length", [
    (0, 16, 16), (0, 64, 60), (0, 512, 512), (256, 16, 16), (256, 256, 256),
    (256, 512, 512), (512, 512, 512), (1000, 24, 24)])
def test_int8_prefill_pieces_meet_the_gate_at_gpt_medium_shapes(
        hist, rows, length):
    """The int8 prefill's numerics (q * s_k and P each in three bf16
    pieces times the exact int8 K and V, summed in float32) lie within the
    card's gate (1e-5 of each output's absolute terms) of the plain
    float32 version at GPT-medium's prefill shapes (12 heads of 128,
    blocks of 16; hist cached keys, rows query rows); with one piece each
    (hi alone) they do not."""
    cpu = torch.device("cpu")
    q, kc, vc, tables, lane, kmax = measure.paged_prefill_case(
        cpu, hist, rows, length, 12, 128, 16, torch.float32,
        seed=hist + rows)
    kc8, vc8, ks, vs = measure.int8_cache(kc, vc)
    want = pa.paged_prefill_plain(q, kc8, vc8, tables[0], kmax, ks, vs)
    terms = pa.abs_terms(q, kc8, vc8, tables, lane, kmax, ks, vs)
    for pieces, ok in ((3, True), (1, False)):
        got = _emulate_prefill_i8(q, kc8, vc8, ks, vs, tables[0], kmax,
                                  pieces)
        reading = measure.paged_reading(got, want, terms, 1e-5)
        assert (reading <= 1) is ok, (pieces, reading)
