"""The window's arithmetic: the rate is all the work over all the time,
the tail is the nearest-rank 95th percentile of every frame, and one
stall shows in both."""
import pytest

from srtbench import stats


def frames_with_stall(n=200, ms=10.0, stall_at=150, stall_ms=500.0):
    t, out = 0.0, []
    for i in range(n):
        d = (stall_ms if i == stall_at else ms) / 1e3
        out.append((t, t + d))
        t += d + 0.001            # the loop's own gap between frames
    return out


def test_rate_counts_all_work_over_all_time():
    fr = frames_with_stall()
    wall = fr[-1][1] - fr[0][0]
    assert stats.window_rate(fr, 1e6) == pytest.approx(200 * 1e6 / wall)
    # the stall and the gaps between frames are in the wall time
    assert wall == pytest.approx((199 * 10 + 500) / 1e3 + 199 * 0.001)
    smooth = frames_with_stall(stall_ms=10.0)
    assert stats.window_rate(fr, 1e6) < 0.85 * stats.window_rate(smooth, 1e6)


def test_p95_is_nearest_rank_over_every_frame():
    assert stats.percentile(list(range(1, 101)), 95) == 95
    assert stats.percentile(list(range(1, 21)), 95) == 19
    assert stats.percentile([5.0], 95) == 5.0
    ms = stats.frame_ms(frames_with_stall(n=20, stall_at=3))
    # one stall in 20 frames is the top 5%: the p95 is the next frame
    assert stats.percentile(ms, 95) == pytest.approx(10.0)
    ms = stats.frame_ms(frames_with_stall(n=20, stall_at=3) +
                        frames_with_stall(n=2, stall_at=0))
    assert stats.percentile(ms, 95) == pytest.approx(500.0)
    with pytest.raises(ValueError):
        stats.percentile([], 95)
