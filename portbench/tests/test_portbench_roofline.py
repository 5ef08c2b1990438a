"""The roofline arithmetic on work counted by hand."""

import pytest

from portbench import roofline


def test_bound_takes_the_larger_roofline():
    assert roofline.bound(67e12, 0.0) == pytest.approx(1.0)
    assert roofline.bound(0.0, 3.35e12) == pytest.approx(1.0)
    assert roofline.bound(67e12, 6.7e12) == pytest.approx(2.0)


def test_mega_work_by_hand():
    # 10 lanes, 4 faces, depth 2; bounce 0: 6 live, 5 of them diffuse;
    # bounce 1: 3 live, 3 diffuse
    ops, nbytes = roofline.mega_work(10, [6, 3], [5, 3], 2, 4)
    origins = 1 * 4 + (6 + 3) * 4             # camera origin, then live
    directions = 10 * 4 + (6 + 5) * 4 + (0 + 3) * 4
    assert ops == origins * 18 + directions * 21
    assert nbytes == 10 * (32 + 64 + 64) + 4 * 176


def test_frame_work_scales_the_sample():
    stats = {"lanes": 5, "live": [3, 1], "diffuse": [3, 1]}
    one = roofline.frame_work(stats, 10, 1, 1, 2, 4, 1 << 20)
    assert one == pytest.approx(roofline.mega_work(10, [6, 2], [6, 2], 2, 4))
    # two launches read the faces twice
    two = roofline.frame_work(stats, 10, 1, 1, 2, 4, 5)
    assert two[0] == pytest.approx(one[0] + 18 * 4)
    assert two[1] == pytest.approx(one[1] + 4 * 176)


def test_mega_work_refuses_lights():
    with pytest.raises(ValueError):
        roofline.mega_work(1, [0], [0], 1, 1, n_lights=1)
