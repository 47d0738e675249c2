"""Interleaver parity vs reference golden permutations.

Reference: src/fec/ldpc_decoder.cpp:454-674, tests/test_interleaver.cpp.
"""

import os

import numpy as np
import pytest

from projectultra.fec.interleave import Interleaver, ChannelInterleaver


def test_block_interleaver_permutation_matches_reference(golden_dir):
    perm = np.array([int(x) for x in
                     open(os.path.join(golden_dir, "golden_interleaver.txt")).read().split()])
    il = Interleaver(6, 108)
    np.testing.assert_array_equal(il.perm, perm)


def test_block_interleaver_roundtrip():
    il = Interleaver(6, 108)
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, size=81, dtype=np.uint8).tobytes()
    assert il.deinterleave(il.interleave(data)) == data
    soft = rng.standard_normal(648).astype(np.float32)
    np.testing.assert_allclose(il.deinterleave_soft(il.interleave_soft(soft)), soft)


def test_channel_interleaver_matches_reference(golden_dir):
    lines = open(os.path.join(golden_dir, "golden_chinterleaver.txt")).read().strip().split("\n")
    for line in lines:
        toks = line.split()
        bps = int(toks[1])
        sep = int(toks[3])
        inv = np.array([int(x) for x in toks[5:]])
        ci = ChannelInterleaver(bps, 648)
        assert ci.symbol_separation == sep
        # golden dump: out[i] = in[inv[i]] after interleave of in[i]=i
        np.testing.assert_array_equal(ci.inv, inv)


def test_channel_interleaver_roundtrip_and_spread():
    ci = ChannelInterleaver(60, 648)
    rng = np.random.default_rng(1)
    soft = rng.standard_normal(648).astype(np.float32)
    np.testing.assert_allclose(ci.deinterleave_soft(ci.interleave_soft(soft)), soft)
    # consecutive input bits land >= symbol_separation symbols apart
    sym_of = ci.perm // ci.bits_per_symbol
    gaps = np.abs(np.diff(sym_of.astype(np.int64)))
    assert ci.symbol_separation >= 3
    assert gaps.min() >= ci.symbol_separation  # the PERMUTATION spreads
