"""LDPC parity tests against golden vectors dumped from the C++ reference.

Covers: H-matrix bit-exactness (via unit encodes), single/multi-block byte
encoding, hard-input decode roundtrip, batched soft decode under noise, and
iteration/early-exit semantics.  Reference: src/fec/ldpc_{encoder,decoder}.cpp.
"""

import os

import numpy as np
import pytest

from projectultra.config import CodeRate
from projectultra.fec import ldpc
from projectultra.ops import ldpc as ldpc_ops
from projectultra.utils.bits import bytes_to_bits, bits_to_bytes

import jax.numpy as jnp

RATES = [CodeRate.R1_4, CodeRate.R1_2, CodeRate.R2_3, CodeRate.R3_4, CodeRate.R5_6]
NAMES = {CodeRate.R1_4: "R1_4", CodeRate.R1_2: "R1_2", CodeRate.R2_3: "R2_3",
         CodeRate.R3_4: "R3_4", CodeRate.R5_6: "R5_6"}


def _golden(golden_dir, rate):
    out = {}
    with open(os.path.join(golden_dir, f"golden_ldpc_{NAMES[rate]}.txt")) as f:
        for line in f:
            toks = line.split()
            for k, v in zip(toks[::2], toks[1::2]):
                out[k] = v
    return out


@pytest.mark.parametrize("rate", RATES)
def test_encode_single_block_matches_reference(golden_dir, rate):
    g = _golden(golden_dir, rate)
    payload = bytes.fromhex(g["payload"])
    code = ldpc.get_code(rate)
    coded = ldpc.encode_bytes_np(code, payload)
    assert coded.hex() == g["coded"]


@pytest.mark.parametrize("rate", RATES)
def test_encode_multi_block_matches_reference(golden_dir, rate):
    g = _golden(golden_dir, rate)
    payload = bytes.fromhex(g["payload2"])
    code = ldpc.get_code(rate)
    coded = ldpc.encode_bytes_np(code, payload)
    assert coded.hex() == g["coded2"]


@pytest.mark.parametrize("rate", RATES)
def test_jax_encode_matches_numpy(rate):
    code = ldpc.get_code(rate)
    rng = np.random.default_rng(0)
    info = rng.integers(0, 2, size=(4, code.k)).astype(np.float32)
    cw = np.asarray(ldpc_ops.encode(code, jnp.asarray(info)))
    for b in range(4):
        ref = ldpc.encode_block_np(code, info[b].astype(np.uint8))
        np.testing.assert_array_equal(cw[b].astype(np.uint8), ref)


@pytest.mark.parametrize("rate", RATES)
def test_hard_decode_roundtrip(golden_dir, rate):
    g = _golden(golden_dir, rate)
    code = ldpc.get_code(rate)
    decoded, ok, iters = ldpc_ops.decode_hard_stream(code, bytes.fromhex(g["coded"]))
    assert ok
    assert int(iters[-1]) == int(g["iters"])  # matches lastIterations()
    assert decoded.hex() == g["decoded"]


@pytest.mark.parametrize("rate,sigma", [(CodeRate.R1_2, 0.55), (CodeRate.R1_4, 0.8)])
def test_soft_decode_corrects_noise(rate, sigma):
    """Batched AWGN LLR decode.  Operating points chosen where the C++
    reference decoder succeeds (verified lane-for-lane identical: same
    success flags, iteration counts and decoded bytes at sigma=0.7/R1_2)."""
    code = ldpc.get_code(rate)
    rng = np.random.default_rng(42)
    B = 16
    info = rng.integers(0, 2, size=(B, code.k)).astype(np.uint8)
    cw = np.stack([ldpc.encode_block_np(code, info[b]) for b in range(B)])
    # BPSK over AWGN: x = 1-2b, y = x + n, LLR = 2y/sigma^2
    x = 1.0 - 2.0 * cw.astype(np.float32)
    y = x + sigma * rng.standard_normal(cw.shape).astype(np.float32)
    llr = 2.0 * y / (sigma * sigma)
    out, ok, iters = ldpc_ops.decode(code, jnp.asarray(llr))
    assert np.asarray(ok).mean() >= 0.9
    good = np.asarray(ok)
    np.testing.assert_array_equal(np.asarray(out)[good], info[good])


def test_decode_early_exit_is_per_lane():
    """A clean codeword in the same batch as a noisy one must converge at its
    own iteration count (frozen-lane semantics)."""
    code = ldpc.get_code(CodeRate.R1_2)
    rng = np.random.default_rng(7)
    info = rng.integers(0, 2, size=(2, code.k)).astype(np.uint8)
    cw = np.stack([ldpc.encode_block_np(code, info[b]) for b in range(2)])
    x = 1.0 - 2.0 * cw.astype(np.float32)
    noisy = x.copy()
    noisy[1] += 0.9 * rng.standard_normal(code.n).astype(np.float32)
    llr = 4.0 * np.stack([x[0], noisy[1]])
    out, ok, iters = ldpc_ops.decode(code, jnp.asarray(llr))
    # Clean lane converges after the first iteration, like the reference.
    assert int(iters[0]) == 0
    assert bool(ok[0])
    np.testing.assert_array_equal(np.asarray(out[0]), info[0])

    # Decoding lane 0 alone gives the identical result.
    out_solo, ok_solo, iters_solo = ldpc_ops.decode(code, jnp.asarray(llr[:1]))
    np.testing.assert_array_equal(np.asarray(out_solo[0]), np.asarray(out[0]))
    assert int(iters_solo[0]) == int(iters[0])


def test_coded_size():
    code = ldpc.get_code(CodeRate.R1_2)
    # 324 info bits = 40.5 bytes; 41 bytes -> 328 bits -> 2 blocks -> 1296 bits
    assert ldpc.coded_size(code, 40) == 81
    assert ldpc.coded_size(code, 41) == 162


def test_bf16_messages_match_f32_at_operating_point():
    """Opt-in bf16 edge messages (ops/ldpc.py msg_dtype): min-sum only
    compares/copies magnitudes, so bf16 rounding must not change decode
    outcomes at the R1/2 17 dB operating point, and the waterfall shift at
    a stressed point must be within noise."""
    code = ldpc.get_code(CodeRate.R1_2)
    rng = np.random.default_rng(9)
    B = 256
    info = jnp.asarray(rng.integers(0, 2, (B, code.k)).astype(np.float32))
    cw = np.asarray(ldpc_ops.encode(code, info))
    # BPSK AWGN LLRs at a comfortable sigma: f32 decodes everything
    # (the R1/2 code is genuinely weak — sigma=0.8 already fails, CLAUDE.md).
    sigma = 0.5
    noise = rng.normal(0, sigma, cw.shape)
    llrs = jnp.asarray((2.0 / sigma**2) * ((1.0 - 2.0 * cw) + noise),
                       dtype=jnp.float32)
    out32, ok32, _ = ldpc_ops.decode(code, llrs, msg_dtype=jnp.float32)
    out16, ok16, _ = ldpc_ops.decode(code, llrs, msg_dtype=jnp.bfloat16)
    ok32 = np.asarray(ok32)
    ok16 = np.asarray(ok16)
    assert ok32.mean() >= 0.97  # weak code: the odd lane fails even here
    assert ok16.mean() >= ok32.mean() - 0.02
    both = ok32 & ok16
    assert (np.asarray(out16)[both] == np.asarray(out32)[both]).all()

    # Stressed point: success rates within a few percent of each other.
    sigma = 0.72
    noise = rng.normal(0, sigma, cw.shape)
    llrs = jnp.asarray((2.0 / sigma**2) * ((1.0 - 2.0 * cw) + noise),
                       dtype=jnp.float32)
    _, ok32, _ = ldpc_ops.decode(code, llrs, msg_dtype=jnp.float32)
    _, ok16, _ = ldpc_ops.decode(code, llrs, msg_dtype=jnp.bfloat16)
    r32 = float(np.asarray(ok32).mean())
    r16 = float(np.asarray(ok16).mean())
    assert abs(r32 - r16) <= 0.04, (r32, r16)
