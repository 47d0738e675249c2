"""CRC-aided parity-free bit recovery (fec/crc_recover.py).

The reference retransmits on frame-CRC failure; recovery of the H
construction's unprotected info bits (ldpc_encoder.cpp:70-128 saturates
check slots at R3/4+R5/6) is a beyond-reference capability, so these tests
are synthetic: corrupt known parity-free positions of a CRC-valid byte
string and require exact repair.
"""

import numpy as np
import pytest

from projectultra.config import CodeRate
from projectultra.fec import crc_recover as CR
from projectultra.fec import ldpc
from projectultra.protocol.frame_v2 import (DATA_CW_HEADER_SIZE,
                                                crc16_ccitt)


def test_crc_bit_deltas_match_bruteforce():
    rng = np.random.default_rng(0)
    msg = bytes(rng.integers(0, 256, 53, dtype=np.uint8))
    base = crc16_ccitt(msg)
    deltas = CR.crc_bit_deltas(len(msg) * 8)
    for p in rng.integers(0, len(msg) * 8, 64):
        buf = bytearray(msg)
        buf[p // 8] ^= 0x80 >> (p % 8)
        assert crc16_ccitt(bytes(buf)) ^ base == deltas[p], p


def test_parity_free_positions():
    assert CR.parity_free_positions(CodeRate.R1_2).size == 0
    pf34 = CR.parity_free_positions(CodeRate.R3_4)
    pf56 = CR.parity_free_positions(CodeRate.R5_6)
    assert pf34.size == 161 and pf34[0] == 325
    assert pf56.size == 323 and pf56[0] == 217
    h56 = ldpc.get_code(CodeRate.R5_6).h_dense
    assert (h56[:, pf56] == 0).all()


def _make_frame(rng, n_cw, rate=CodeRate.R5_6):
    """CRC-valid synthetic frame spanning n_cw codewords + matching LLRs."""
    code = ldpc.get_code(rate)
    bpc = code.k // 8
    L = bpc + (n_cw - 1) * (bpc - DATA_CW_HEADER_SIZE)
    msg = bytes(rng.integers(0, 256, L - 2, dtype=np.uint8))
    frame = msg + crc16_ccitt(msg).to_bytes(2, "big")
    # Mirror the measured landscape: correct bits clip at |llr|=10 (signs
    # arbitrary — only |llr| is used by recovery).
    llrs = [np.where(rng.random(code.n) < 0.5, -10.0, 10.0).astype(np.float32)
            for _ in range(n_cw)]
    return frame, llrs, bpc


def _frame_bit(c, j, bpc):
    """Frame bit index of codeword c's info bit j under the stripped-header
    reassembly layout (frame_v2.reassemble_codewords)."""
    skip = 0 if c == 0 else DATA_CW_HEADER_SIZE
    fbyte0 = 0 if c == 0 else bpc + (c - 1) * (bpc - DATA_CW_HEADER_SIZE)
    return (fbyte0 + j // 8 - skip) * 8 + j % 8


def _corrupt(rng, frame, llrs, bpc, n_flips, rate=CodeRate.R5_6):
    pf = CR.parity_free_positions(rate)
    usable = [j for j in pf if DATA_CW_HEADER_SIZE <= j // 8 < bpc]
    corrupt = bytearray(frame)
    picks = set()
    while len(picks) < n_flips:
        picks.add((int(rng.integers(0, len(llrs))), int(rng.choice(usable))))
    for c, j in picks:
        fb = _frame_bit(c, j, bpc)
        if fb >= len(frame) * 8 - 16:
            continue
        corrupt[fb // 8] ^= 0x80 >> (fb % 8)
        # wrong bits read low-confidence (measured 0.5-3.0 vs the 10 clip)
        llrs[c][j] = float(rng.uniform(0.5, 3.0))
    return bytes(corrupt)


@pytest.mark.parametrize("n_flips", [1, 2, 3])
def test_recover_exact(n_flips):
    rng = np.random.default_rng(10 + n_flips)
    frame, llrs, bpc = _make_frame(rng, n_cw=4)
    corrupt = _corrupt(rng, frame, llrs, bpc, n_flips)
    if corrupt == frame:
        pytest.skip("all picks landed in the CRC field")
    got = CR.recover_frame(corrupt, llrs, CodeRate.R5_6, len(frame))
    assert got == frame


def test_four_flips_not_falsely_recovered():
    """Quads are out of search scope (16-bit syndrome chance-match risk):
    recovery must return None, never a wrong frame."""
    rng = np.random.default_rng(14)
    frame, llrs, bpc = _make_frame(rng, n_cw=4)
    corrupt = _corrupt(rng, frame, llrs, bpc, 4)
    got = CR.recover_frame(corrupt, llrs, CodeRate.R5_6, len(frame))
    assert got is None or got == frame


@pytest.mark.parametrize("rate", [CodeRate.R3_4, CodeRate.R5_6])
def test_dense_corruption_never_falsely_recovered(rate):
    """Standing STATISTICAL false-accept gate for the sparse-pool guard
    (VERDICT r4 weak #3 / next #6).

    The guard (SPARSE_POOL_MAX=12) was sized from one archived measurement:
    dense corruption (R3/4 image leakage at cfo >= 0.5 Hz — dozens of wrong
    parity-free bits) chance-matched the 16-bit CRC syndrome 5/8 times
    unguarded, delivering CRC-valid WRONG frames.  This regression feeds
    100 dense-corrupted frames per rate (200 total) through recovery and
    requires ZERO false accepts; if a future change widens the pool gate or
    the search depth, the chance-match rate (~0.16/frame at a 40-candidate
    pool with triples) trips this within a handful of frames.
    """
    rng = np.random.default_rng(0xDE45E + int(rate))
    code = ldpc.get_code(rate)
    bpc = code.k // 8
    N = 100
    false_accepts = 0
    declined = 0
    for _ in range(N):
        frame, llrs, _ = _make_frame(rng, n_cw=4, rate=rate)
        n_flips = int(rng.integers(16, 60))  # dense regime: >> pool cap
        corrupt = _corrupt(rng, frame, llrs, bpc, n_flips, rate=rate)
        got = CR.recover_frame(corrupt, llrs, rate, len(frame))
        if got is None:
            declined += 1
        elif got != frame:
            false_accepts += 1
    assert false_accepts == 0, f"{false_accepts}/{N} CRC-valid WRONG frames"
    # Dense corruption must be DECLINED (fall through to ARQ), not searched:
    # the guard engaging is the mechanism under test.
    assert declined >= int(0.95 * N), declined


def test_recover_crc_field_flip():
    """A parity-free flip inside the stored CRC itself is also findable."""
    rng = np.random.default_rng(77)
    frame, llrs, bpc = _make_frame(rng, n_cw=2)
    pf = set(CR.parity_free_positions(CodeRate.R5_6).tolist())
    crc_bit = (len(frame) - 2) * 8 + 5
    c, j = 1, None
    # find the codeword bit that maps onto that frame bit
    for jj in range(540):
        if jj // 8 >= DATA_CW_HEADER_SIZE and _frame_bit(1, jj, bpc) == crc_bit:
            j = jj
            break
    if j is None or j not in pf:
        pytest.skip("CRC field not parity-free at this geometry")
    corrupt = bytearray(frame)
    corrupt[crc_bit // 8] ^= 0x80 >> (crc_bit % 8)
    llrs[c][j] = 0.01
    got = CR.recover_frame(bytes(corrupt), llrs, CodeRate.R5_6, len(frame))
    assert got == frame


def test_recover_none_when_consistent_or_protected():
    rng = np.random.default_rng(5)
    frame, llrs, bpc = _make_frame(rng, n_cw=2)
    # consistent CRC -> nothing to do
    assert CR.recover_frame(frame, llrs, CodeRate.R5_6, len(frame)) is None
    # protected-rate frame (no parity-free bits) -> no candidates
    corrupt = bytearray(frame)
    corrupt[40] ^= 1
    assert CR.recover_frame(bytes(corrupt), llrs, CodeRate.R1_2,
                            len(frame)) is None


def test_recover_prefers_low_llr_on_ambiguity():
    """If two singles match the syndrome, the lower-|LLR| one is chosen."""
    rng = np.random.default_rng(42)
    frame, llrs, bpc = _make_frame(rng, n_cw=4)
    pf = CR.parity_free_positions(CodeRate.R5_6)
    usable = [j for j in pf if DATA_CW_HEADER_SIZE <= j // 8 < bpc]
    j = int(usable[7])
    fb = _frame_bit(2, j, bpc)
    corrupt = bytearray(frame)
    corrupt[fb // 8] ^= 0x80 >> (fb % 8)
    llrs[2][j] = 0.02
    got = CR.recover_frame(bytes(corrupt), llrs, CodeRate.R5_6, len(frame))
    assert got == frame
