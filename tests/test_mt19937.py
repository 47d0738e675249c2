"""MT19937 bit-exactness vs std::mt19937 (values generated with g++ 12).

The LDPC H matrices and pilot sequences depend on exact 32-bit MT streams
(reference: src/fec/ldpc_encoder.cpp:77, src/ofdm/modulator.cpp:39).
"""

from projectultra.utils.mt19937 import MT19937, fisher_yates_inplace

# First three outputs of std::mt19937 for each seed (g++ 12.2, libstdc++).
KNOWN = {
    0x12345678: [3331822403, 157471482, 2805605540],
    0x1234567A: [2687482102, 793980782, 3860499638],
    0x50494C54: [3432538753, 2152995101, 1995766469],
    5489: [3499211612, 581869302, 3890346734],
}

# Output index 623/624 (twist boundary) and 1499 for seed 0x12345678.
BOUNDARY = {623: 1964177606, 624: 1580957920, 1499: 3204575100}


def test_first_outputs():
    for seed, expected in KNOWN.items():
        r = MT19937(seed)
        assert [r() for _ in range(3)] == expected


def test_twist_boundary():
    r = MT19937(0x12345678)
    vals = [r() for _ in range(1500)]
    for idx, v in BOUNDARY.items():
        assert vals[idx] == v


def test_raw_block_matches_scalar():
    a, b = MT19937(123), MT19937(123)
    import numpy as np
    block = a.raw(2000)
    scalar = np.array([b() for _ in range(2000)], dtype=np.uint32)
    np.testing.assert_array_equal(block, scalar)


def test_fisher_yates_matches_cpp_pattern():
    # First few draws of `rng() % i` for i=324..: from g++ dump.
    expected = [155, 261, 220, 169, 59, 247, 177, 10, 252, 120]
    r = MT19937(0x12345678)
    got = [r() % i for i in range(324, 314, -1)]
    assert got == expected
