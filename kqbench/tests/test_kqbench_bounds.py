"""The least-bytes formulas and the shares they give."""

import pytest

from kqbench import bounds


def test_count_bytes():
    # 8M bases at 2 bits, 6M rows at 44 B
    assert bounds.count_bytes(8_000_000, 6_000_000) == 2_000_000 + 264_000_000


def test_merge_bytes():
    assert bounds.merge_bytes(10, 20, 25) == 55 * 44


def test_track_probe_bytes():
    # bases at 2 bits, 12 B a window, 44 B a distinct row found
    assert bounds.track_probe_bytes(400, 380, 300) == 100 + 380 * 12 \
        + 300 * 44


def test_share_against_the_peak():
    assert bounds.HBM_BYTES_PER_S == 3.35e12
    assert bounds.seconds(3.35e9) == pytest.approx(1e-3)
    # 3.35 GB in 2 ms is half the peak
    assert bounds.share(3.35e9, 2e-3) == pytest.approx(50.0)
    assert bounds.share(1.0, 0.0) is None
