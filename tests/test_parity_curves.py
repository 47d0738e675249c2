"""Gate for the reference-vs-ours FER overlay artifact (VERDICT r4 #2).

PARITY_CURVES.json is produced by tools/parity_curves.py: the COMPILED
reference's own primary harness (tools/test_iwaveform.cpp) and our
flag-for-flag single-stream harness run the same operating points (every
regression_matrix.sh row the reference can run + OFDM_COX link-table rows)
at the reference's own frame counts over the same seed list.  This test
pins the BASELINE.md north-star clause — decode parity with the C++
reference at every tabulated point — against the committed artifact.
"""

import json
import os

import pytest

ART = os.path.join(os.path.dirname(__file__), "..", "PARITY_CURVES.json")


@pytest.fixture(scope="module")
def curves():
    if not os.path.exists(ART):
        pytest.fail("PARITY_CURVES.json missing — run tools/parity_curves.py")
    with open(ART) as f:
        return json.load(f)


def test_ours_at_or_above_reference_everywhere(curves):
    below = [p for p in curves["points"]
             if p["our_decoded"] < p["ref_decoded"]]
    assert not below, below
    assert curves["all_points_at_or_above_reference"] is True


def test_covers_every_reference_matrix_row(curves):
    """Every regression_matrix.sh row the reference harness can run
    (MC_DPSK + OFDM_CHIRP, basic + --full tiers) must be in the overlay."""
    from projectultra.parallel.sweep import REGRESSION_MATRIX, FULL_EXTRA
    have = {(p["waveform"], p["snr_db"], p["cfo_hz"], p["channel"])
            for p in curves["points"]}
    for point, _min in list(REGRESSION_MATRIX) + list(FULL_EXTRA):
        if point.waveform == "DPSK":
            continue  # ours alone — the reference has no single-carrier harness
        key = (point.waveform, point.snr_db, point.cfo_hz, point.channel)
        assert key in have, key


def test_statistical_weight_and_cox_rows(curves):
    """Each point aggregates >=3 seeds x the reference's own frame count,
    and the OFDM_COX rows (where the reference's own streaming RX decodes
    0% — measured) are present with ours decoding."""
    for p in curves["points"]:
        assert p["ref_total"] == p["our_total"] >= 15, p
    cox = [p for p in curves["points"] if p["waveform"] == "OFDM_COX"]
    assert len(cox) >= 3
    for p in cox:
        assert p["our_decoded"] >= 0.8 * p["our_total"], p
