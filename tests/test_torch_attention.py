"""The port's attention op against the JAX package's
``scaled_dot_product_attention`` and ``jax.grad`` of it, on the CPU.

The same seeded float32 inputs go through both. On the CPU the op runs
the kernels' plain versions (``attention_fwd_plain`` and the FA2-scheme
``attention_bwd_plain`` behind ``Attention``), or ``sdpa_plain`` with an
explicit mask. Tolerance: 1e-5 of each output's largest magnitude (float32
sums in another order; with x64 on, the JAX op multiplies the float32
scores by a numpy float64 scale, so its softmax runs in float64). The
plain versions against each other in float64: 1e-12.
"""
import ctypes
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import nn_ops as jnn
from deeplearning4j_tpu_torch.kernels import _cuda
from deeplearning4j_tpu_torch.kernels import attention as at
from deeplearning4j_tpu_torch.ops import nn_ops as pnn


def _inputs(b, h, sq, sk, d, seed=0, split=False):
    rng = np.random.default_rng(seed)
    if split:
        qkv = rng.normal(size=(b, sq, h, 3 * d)).astype(np.float32)
        qkv = qkv.transpose(0, 2, 1, 3)
        q, k, v = (qkv[..., i * d:(i + 1) * d] for i in range(3))
    else:
        q = rng.normal(size=(b, h, sq, d)).astype(np.float32)
        k, v = (rng.normal(size=(b, h, sk, d)).astype(np.float32)
                for _ in range(2))
    do = rng.normal(size=(b, h, sq, d)).astype(np.float32)
    return q, k, v, do


def _jax(q, k, v, do, causal, mask=None):
    def f(q, k, v):
        return jnn.scaled_dot_product_attention(
            q, k, v, mask=None if mask is None else jnp.asarray(mask),
            causal=causal)
    o, vjp = jax.vjp(f, *(jnp.asarray(t) for t in (q, k, v)))
    return [np.asarray(o)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port(fn, q, k, v, do, causal, **kw):
    ts = [torch.as_tensor(np.ascontiguousarray(t)).requires_grad_(True)
          for t in (q, k, v)]
    o = fn(*ts, causal=causal, **kw)
    return [o.detach().numpy()] + [
        g.numpy() for g in torch.autograd.grad(o, ts, torch.as_tensor(do))]


def _close(got, want, rtol=1e-5):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        err = float(np.max(np.abs(g.astype(np.float64) - w)))
        assert err <= rtol * max(float(np.max(np.abs(w))), 1e-30), err


CASES = [  # (b, h, sq, sk, d, causal)
    (2, 3, 17, 17, 16, True),
    (2, 3, 17, 17, 16, False),
    (1, 2, 9, 21, 32, True),       # Sq < Sk
    (1, 2, 21, 9, 32, True),       # Sq > Sk: rows 0-11 fully masked
    (1, 1, 1, 1, 16, True),
]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("fn", ["op", "sdpa_plain"])
def test_attention_and_its_grads_match_jax(case, fn):
    b, h, sq, sk, d, causal = case
    q, k, v, do = _inputs(b, h, sq, sk, d)
    f = pnn.scaled_dot_product_attention if fn == "op" else at.sdpa_plain
    _close(_port(f, q, k, v, do, causal), _jax(q, k, v, do, causal))


def test_fully_masked_rows_average_v_as_the_reference_does():
    q, k, v, do = _inputs(1, 2, 21, 9, 32, seed=3)
    got = _port(pnn.scaled_dot_product_attention, q, k, v, do, True)
    np.testing.assert_allclose(got[0][:, :, :12],
                               np.broadcast_to(v.mean(axis=2, keepdims=True),
                                               (1, 2, 12, 32)),
                               rtol=1e-5, atol=1e-6)
    # no gradient reaches q through a fully masked row
    assert np.all(got[1][:, :, :12] == 0)


@pytest.mark.parametrize("causal", [True, False])
def test_explicit_mask_on_the_cpu_matches_jax(causal):
    q, k, v, do = _inputs(2, 2, 11, 11, 16, seed=4)
    mask = np.random.default_rng(5).random((2, 1, 11, 11)) > 0.3
    got = _port(pnn.scaled_dot_product_attention, q, k, v, do, causal,
                mask=torch.as_tensor(mask))
    _close(got, _jax(q, k, v, do, causal, mask=mask))


def test_build_gpt_strided_views_match_jax():
    """q, k and v as build_gpt hands them over: views of one permuted
    [B, S, H, 3D] tensor, last stride 1, no copy."""
    q, k, v, do = _inputs(2, 4, 16, 16, 16, seed=6, split=True)
    qkv = torch.as_tensor(np.random.default_rng(6).normal(
        size=(2, 16, 4, 48)).astype(np.float32)).permute(0, 2, 1, 3)
    tq, tk, tv = torch.split(qkv, 16, dim=3)
    assert tq.stride() == (3072, 48, 192, 1) and not tq.is_contiguous()
    assert np.array_equal(tk.numpy(), k)
    ts = [t.detach().requires_grad_(True) for t in (tq, tk, tv)]
    o = pnn.scaled_dot_product_attention(*ts, causal=True)
    got = [o.detach().numpy()] + [g.numpy() for g in torch.autograd.grad(
        o, ts, torch.as_tensor(do))]
    _close(got, _jax(q, k, v, do, True))


@pytest.mark.parametrize("case", CASES)
def test_plain_fwd_bwd_equal_autograd_of_sdpa_plain_in_float64(case):
    """The kernels' functions (stats, delta, dS from recomputed P) are the
    autograd of the op's line-by-line math."""
    b, h, sq, sk, d, causal = case
    q, k, v, do = (torch.as_tensor(t, dtype=torch.float64)
                   for t in _inputs(b, h, sq, sk, d, seed=8))
    o, stats = at.attention_fwd_plain(q, k, v, causal)
    got = (o,) + at.attention_bwd_plain(q, k, v, o, do, stats, causal)
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = at.sdpa_plain(*ts, causal=causal)
    want = (ref.detach(),) + torch.autograd.grad(ref, ts, do)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-12 * max(
            float(w.abs().max()), 1.0)
    assert stats.shape == (b, h, sq, 2) and stats.dtype == torch.float64


def test_bf16_plain_rounds_p_and_ds_before_their_products():
    q, k, v, do = (torch.as_tensor(t).to(torch.bfloat16)
                   for t in _inputs(1, 2, 33, 33, 32, seed=9))
    o, stats = at.attention_fwd_plain(q, k, v, True)
    assert o.dtype == torch.bfloat16 and stats.dtype == torch.float32
    grads = at.attention_bwd_plain(q, k, v, o, do, stats, True)
    f = [t.float() for t in (q, k, v, do)]
    ts = [t.clone().requires_grad_(True) for t in f[:3]]
    ref = at.sdpa_plain(*ts, causal=True)
    want = torch.autograd.grad(ref, ts, f[3])
    for g, w in zip((o,) + grads, (ref.detach(),) + want):
        assert g.dtype == torch.bfloat16
        err = float((g.float() - w).abs().max())
        assert err <= 2e-2 * float(w.abs().max()), err


def test_cpu_op_counts_no_launch_and_takes_any_head_dim():
    at.reset_launches()
    q = torch.randn(1, 2, 5, 24)
    o = pnn.scaled_dot_product_attention(q, q, q, causal=True)
    assert o.shape == q.shape
    assert at.LAUNCHES == {n: 0 for n in at.LAUNCHES}


def test_meta_tensors_infer_shapes_through_the_plain_version():
    q = torch.empty(2, 3, 7, 16, device="meta")
    o = pnn.scaled_dot_product_attention(q, q, q, causal=True)
    assert o.shape == (2, 3, 7, 16) and o.device.type == "meta"


@pytest.mark.parametrize("bad,match", [
    ((torch.zeros(2, 3, 4), torch.zeros(2, 3, 4), torch.zeros(2, 3, 4)),
     "batch, heads"),
    ((torch.zeros(1, 2, 4, 8), torch.zeros(1, 3, 4, 8),
      torch.zeros(1, 3, 4, 8)), "do not match"),
    ((torch.zeros(1, 2, 4, 8), torch.zeros(1, 2, 4, 8, dtype=torch.float64),
      torch.zeros(1, 2, 4, 8)), "dtypes differ"),
    ((torch.zeros(1, 2, 0, 8), torch.zeros(1, 2, 4, 8),
      torch.zeros(1, 2, 4, 8)), "empty"),
])
def test_op_refuses_mismatched_inputs(bad, match):
    with pytest.raises(ValueError, match=match):
        at.attention_fwd(*bad, True)


# ----------------------------------------------------------------------
# the binding: nvcc command, ctypes declarations held to the C source
ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "deeplearning4j_tpu_torch" / "csrc" / "causal_attention.cu"


def _c_entry_params():
    """(type, name) of the C entries' parameters, from the .cu source, and
    the entries the source defines."""
    src = SRC.read_text()
    m = re.search(r'extern "C" int name\((.*?)\)\s*\{', src, re.S)
    params = [p.strip() for p in m.group(1).replace("\\", " ").split(",")]
    entries = re.findall(r"DL4J_ATTENTION_ENTRY\((dl4j_\w+), (\w+)\)", src)
    return [(" ".join(p.split()[:-1]), p.split()[-1]) for p in params], \
        entries


def test_ctypes_declaration_matches_the_c_entries():
    c_types = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
               "int64_t": ctypes.c_int64, "int": ctypes.c_int,
               "double": ctypes.c_double, "int*": ctypes.c_void_p}
    params, entries = _c_entry_params()
    assert [n for _, n in params] == [n for n, _ in at.ATTENTION_ARGTYPES]
    assert [c_types[t] for t, _ in params] == [
        t for _, t in at.ATTENTION_ARGTYPES]
    # every pointer, the work counter and the stream go as c_void_p, never
    # as a 32-bit int
    pointers = [n for t, n in params if t.endswith("*")]
    assert {"work", "stream"} <= set(pointers) and len(pointers) == 13
    assert [e for e, _ in entries] == list(at.ENTRIES)
    assert [w for _, w in entries] == ["kFwd", "kDelta", "kDkdv", "kDq"]
    assert [e[len("dl4j_"):] for e in at.ENTRIES] == list(at.LAUNCHES)


def test_loading_the_library_declares_every_entry(monkeypatch):
    class Entry:
        argtypes = None
        restype = ctypes.c_int

    class Lib:
        pass

    lib = Lib()
    for name in at.ENTRIES:
        setattr(lib, name, Entry())
    monkeypatch.setattr(_cuda, "load", lambda name: lib)
    assert at._lib() is lib
    want = [t for _, t in at.ATTENTION_ARGTYPES]
    for name in at.ENTRIES:
        fn = getattr(lib, name)
        assert fn.argtypes == want and fn.restype is ctypes.c_int


def test_nvcc_command_builds_the_attention_source_for_sm90a():
    out = _cuda.library_path("causal_attention")
    cmd = _cuda.build_command("causal_attention", out, "nvcc")
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert cmd[-1] == str(SRC)
    assert pathlib.Path(out).parent == \
        ROOT / "deeplearning4j_tpu_torch" / "_build" / "cuda"
    assert re.fullmatch(r"libcausal_attention-[0-9a-f]{16}\.so",
                        pathlib.Path(out).name)


def test_bf16_kernels_are_wgmma_and_tma_with_no_mma_sync_left():
    """The bf16 kernels read their tiles with TMA (tensor maps encoded by
    the host through cudaGetDriverEntryPoint, no libcuda link) and
    multiply with wgmma (the source with the port's header of Hopper
    primitives, which it includes); the first design's mma.sync, ldmatrix
    and cp.async are gone. The header's tf32 mma.sync helpers are the
    float32 kernels': this source calls none of them."""
    text = SRC.read_text()
    assert '#include "sm90.cuh"' in text
    own = "\n".join(line.split("//")[0] for line in text.splitlines())
    text += (SRC.parent / "sm90.cuh").read_text()
    code = "\n".join(line.split("//")[0] for line in text.splitlines())
    for inst in ("wgmma.mma_async", "cp.async.bulk.tensor.4d",
                 "mbarrier.try_wait.parity", "setmaxnreg",
                 "cuTensorMapEncodeTiled"):
        assert inst in code, inst
    for inst in ("mma.sync", "mma_tf32(", "mma3_tf32("):
        assert inst not in own, inst
    for inst in ("ldmatrix", "cp.async.cg"):
        assert inst not in code, inst
    for name in ("attention_fwd_bf16", "attention_bwd_dkdv_bf16",
                 "attention_bwd_dq_bf16"):
        assert re.search(name + r"\(const __grid_constant__ TmaArgs p\)",
                         code), name
    assert "-lcuda" not in _cuda.NVCC_FLAGS


@pytest.mark.parametrize("view,copied", [
    ("contiguous", False), ("split_q", False), ("split_k", False),
    ("split_v", False), ("rows_130_bytes", True),
    ("heads_1026_bytes", True), ("offset_2_bytes", True)])
def test_tma_copy_rule_copies_only_bf16_views_off_16_bytes(view, copied):
    """What the wrappers hand TMA: a bf16 tensor whose base or batch, head
    or row stride is not a multiple of 16 bytes is replaced by a
    contiguous copy with the same values, and counted; build_gpt's split
    views and float32 tensors pass as they are."""
    b, h, s, d = 2, 3, 8, 64
    if view == "contiguous":
        t = torch.randn(b, h, s, d).to(torch.bfloat16)
    elif view.startswith("split"):
        qkv = torch.randn(b, s, h, 3 * d).to(torch.bfloat16).permute(
            0, 2, 1, 3)
        t = torch.split(qkv, d, dim=3)["qkv".index(view[-1])]
    elif view == "rows_130_bytes":
        t = torch.randn(b, h, s, d + 1).to(torch.bfloat16)[..., :d]
    elif view == "heads_1026_bytes":
        t = torch.randn(b, h, s * d + 1).to(torch.bfloat16)[
            ..., :s * d].unflatten(2, (s, d))
    else:
        flat = torch.randn(b * h * s * d + 1).to(torch.bfloat16)
        t = flat[1:].view(b, h, s, d)
    counter = {"k": 0}
    (got,) = at._for_tma((t,), counter, "k")
    assert counter["k"] == int(copied)
    assert (got is not t) == copied and torch.equal(got, t)
    if copied:
        assert got.is_contiguous() and at._rows_aligned([got])
    (f32,) = at._for_tma((t.float(),), counter, "k")
    assert counter["k"] == int(copied)
