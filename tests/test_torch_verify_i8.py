"""The identities the int8-cache verify kernel (``paged_verify_i8_kernel``
in ``csrc/paged_attention.cu``) rests on, emulated in numpy float32, its
source's shape, and ``chip_smoke.py``'s test for a profiler pass that lost
whole steps' records.

- An int8 value x becomes float32 without the conversion pipe: the bits
  0x4B000000 | (x ^ 0x80) are the float 2^23 + x + 128, and one float32
  addition of -(2^23 + 128) leaves x exactly, for all 256 values.
- A score's G lane partials summed in a thread's registers in the shuffle
  butterfly's pairing (lanes l and l ^ off, off = G / 2 .. 1; the kernel
  sums the lanes of one quarter, l = qb mod 4, in registers, then the
  levels off = 2 and 1 across the quarters) give the butterfly's bits:
  every lane of the butterfly ends with that value.
"""
import pathlib
import re
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = (ROOT / "deeplearning4j_tpu_torch" / "csrc" / "paged_attention.cu"
       ).read_text()
f32 = np.float32


def _i8x4(x):
    """The kernel's conversion of int8 values ``x`` (an int8 array)."""
    u = (x.astype(np.int32) ^ 0x80) & 0xFF
    bits = (np.uint32(0x4B000000) | u.astype(np.uint32)).astype(np.uint32)
    return (bits.view(np.float32) + f32(-8388736.0)).astype(np.float32)


def test_byte_permute_conversion_is_exact_for_every_int8():
    x = np.arange(-128, 128, dtype=np.int8)
    got = _i8x4(x)
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32),
                          x.astype(np.float32).view(np.uint32))


def test_source_conversion_matches_the_emulation():
    """The source builds each value as the emulation does: the sign bits
    flipped, byte b under 0x4B000000 by a byte permute (selectors 0x7540 +
    b: the byte, two zero bytes, 0x4B), one FADD of -(2^23 + 128)."""
    body = SRC[SRC.index("float4 i8x4(uint32_t w)"):]
    body = body[:body.index("\n}\n")]
    assert "w ^ 0x80808080u" in body
    assert "-8388736.0f" in body
    assert [int(s, 16) for s in re.findall(
        r"__byte_perm\(x, 0x4B000000u, (0x754\d)\)", body)] == \
        [0x7540, 0x7541, 0x7542, 0x7543]
    assert float(np.float32(2 ** 23 + 128)) == 8388736.0


def _butterfly(p):
    """The decode's shuffle butterfly over a key's G lanes (each lane's
    value after every level), float32."""
    g = len(p)
    v = p.copy()
    off = g // 2
    while off:
        v = (v + v[np.arange(g) ^ off]).astype(np.float32)
        off //= 2
    return v


def _quarter_tree(p):
    """The kernel's form: quarter qb holds lanes 4 m + qb (m < G / 4); its
    entries summed in registers in the butterfly's pairing (level v: m and
    m + (G / 4 >> v), lanes l and l ^ 4 (G / 4 >> v)), then lanes l ^ 2
    and l ^ 1 across the quarters, in that order."""
    g = len(p)
    qn = g // 4
    part = []
    for qb in range(4):
        pt = [p[4 * m + qb] for m in range(qn)]
        v = 1
        while qn >> v:
            o = qn >> v
            for m in range(o):
                pt[m] = f32(pt[m] + pt[m + o])
            v += 1
        part.append(pt[0])
    after2 = [f32(part[qb] + part[qb ^ 2]) for qb in range(4)]
    return [f32(after2[qb] + after2[qb ^ 1]) for qb in range(4)]


@pytest.mark.parametrize("g", [4, 8, 16, 32])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tree_in_registers_equals_the_butterfly_bit_for_bit(g, seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        # partials of wide range, as a lane's E-term FMA chains give them
        p = (rng.standard_normal(g) * np.exp(rng.uniform(-8, 8, g))
             ).astype(np.float32)
        bf = _butterfly(p)
        assert len(set(bf.view(np.uint32).tolist())) == 1   # every lane
        got = np.array(_quarter_tree(p), dtype=np.float32)
        assert np.array_equal(got.view(np.uint32),
                              np.full(4, bf[0], np.float32).view(np.uint32))


@pytest.mark.parametrize("g", [4, 8, 16, 32])
def test_a_sequential_sum_is_not_the_butterfly(g):
    """Control: a lane-order sum differs from the butterfly in some bits,
    so the tree test above is not vacuous."""
    rng = np.random.default_rng(g)
    differ = 0
    for _ in range(200):
        p = (rng.standard_normal(g) * np.exp(rng.uniform(-8, 8, g))
             ).astype(np.float32)
        s = f32(0)
        for x in p:
            s = f32(s + x)
        differ += s != _butterfly(p)[0]
    assert differ > 0


def test_verify_over_an_int8_cache_in_float32_is_its_own_kernel():
    """The float32 verify over an int8 cache launches
    paged_verify_i8_kernel; every other instantiation keeps
    paged_verify_kernel. The new kernel: q's quarter-rows folded with s_k
    once, the quarter tree and two shuffles (no per-key butterfly), exact
    conversions by byte permutes (no cast of an int8 to float), window
    keys from the group's rows quantised once, 16-byte stores of the
    written rows, no atomics."""
    code = "\n".join(line.split("//")[0] for line in SRC.splitlines())
    launch = code[code.index("int launch_verify(Args a, int64_t N, "
                             "cudaStream_t st) {"):]
    launch = launch[:launch.index("\n}\n")]
    assert "if constexpr (sizeof(T) == 4 && sizeof(C) == 1) {" in launch
    assert "return launch_verify_i8<D>(a, N, st);" in launch
    body = code[code.index("paged_verify_i8_kernel(const Args a) {"):]
    body = body[:body.index("\ntemplate <int D>\ncudaError_t "
                            "configure_verify_i8()")]
    assert "qh[m][e] = row < a.N ? fold<true>(qp[d], ks + d) : 0.0f;" in body
    assert body.count("__shfl_xor_sync") == 2
    assert "__shfl_xor_sync(kFull, pt[0], 16)" in body
    assert "__shfl_xor_sync(kFull, dot, 8)" in body
    assert "if (m < (QN >> v)) pt[m] = __fadd_rn(pt[m], pt[m + (QN >> v)]);" \
        in body
    assert not re.search(r"static_cast<(float|T)>\((x|xs|c)\b", body)
    assert "i8x4(" in body and "ldkv" not in body
    assert "s_new[kv][r][d] = r0 + r < a.N ? stored<int8_t>(xnew[j]" in body
    assert "*reinterpret_cast<uint4*>(dst + 16 * c16) =" in body
    assert "atomic" not in code
    # the rows' last step is the decode's: p V and l in its order, s_v
    # in the rank-ordered combine
    assert "acc[x][0] = __fmaf_rn(p, vv.x, acc[x][0]);" in body
    assert "l4[x] = __fadd_rn(l4[x], p);" in body
    assert "res = fold<true>(oc8, &s_sc[1][d]) / lc8;" in body


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


@pytest.mark.parametrize("short,full,steps,want", [
    ({"bn": 7 * 33, "conv": 7 * 100, "add": 7 * 5},
     {"bn": 8 * 33, "conv": 8 * 100, "add": 8 * 5}, 8, 1),
    ({"bn": 6 * 20, "conv": 6 * 3}, {"bn": 8 * 20, "conv": 8 * 3}, 8, 2),
    # a kernel short where the others are not: a launch that did not happen
    ({"bn": 7 * 33, "conv": 8 * 100}, {"bn": 8 * 33, "conv": 8 * 100}, 8,
     None),
    # short by less than a step
    ({"bn": 8 * 33 - 1, "conv": 8 * 100 - 3},
     {"bn": 8 * 33, "conv": 8 * 100}, 8, None),
    # a kernel only one pass holds
    ({"bn": 7 * 33}, {"bn": 8 * 33, "conv": 8 * 100}, 8, None),
    # nothing lost
    ({"bn": 8 * 33}, {"bn": 8 * 33}, 8, None),
])
def test_whole_steps_lost_tells_a_profiler_loss_from_a_missing_launch(
        short, full, steps, want):
    assert _chip_smoke().whole_steps_lost(short, full, steps) == want
