"""A run on the CPU at a tiny size, the card check skipped: sound, it
is correct; with each fault of portbench.faults planted under the timed
path, `correct` comes out false; the control (the reference with its
hit test in TF32 in the program's place) fails the comparison."""

import pytest
import torch

from portbench import compare, faults, readings
from portbench.tests import _tiny


def test_sound_run_is_correct():
    out = _tiny.execute()
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == {"pixels_off", "chunk_off_max"}


@pytest.mark.parametrize("fault", sorted(faults.FRAME))
def test_frame_fault_is_not_correct(fault):
    with faults.FRAME[fault]():
        out = _tiny.execute(seconds=3.0)
    assert out["attempted"] >= 2
    assert not out["correct"], out["checks"]


def test_control_and_faults_fail_through_the_verdict():
    c = _tiny.cell()
    for row in readings.frame_readings(c, [11, 12], torch.device("cpu"),
                                       control=True, plant=True):
        assert row["program"]["correct"], row
        for name in ["control"] + sorted(faults.FRAME):
            assert not row[name]["correct"], (name, row)
        assert set(faults.SMALL) <= set(row)


def test_every_chunk_is_sampled():
    from portbench.kinds import frame

    c = _tiny.cell()
    import tinypathtracer_tpu_torch as T
    from portbench import scenes

    rcfg = T.RenderConfig(**scenes.render_args(c.config))
    imgs = [torch.zeros((rcfg.height, rcfg.width, 3)) for _ in range(3)]
    which, pix, chunk, _ = frame.sample_pixels(imgs, 5, 16, rcfg)
    px = frame.chunk_pixels(rcfg)
    n_chunks = -(-rcfg.n_pixels // px)
    assert n_chunks == 6 and rcfg.n_pixels % px == 16     # one ragged
    assert torch.equal(torch.bincount(chunk), torch.full((n_chunks,), 16))
    assert torch.equal(pix // px, chunk)
    assert int(pix.max()) < rcfg.n_pixels and int(which.max()) < 3


def test_chunk_numbers_by_hand():
    ref = torch.zeros((6, 3))
    port = ref.clone()
    port[4:] = 1.0                                 # chunk 1: both off
    chunk = torch.tensor([0, 0, 0, 0, 1, 1])
    n = compare.frame_numbers(port, ref, chunk)
    assert n == {"pixels_off": pytest.approx(2 / 6), "chunk_off_max": 1.0}
    port[4:] = ref[4:] + 5e-5                      # within the tolerance
    assert compare.frame_numbers(port, ref, chunk)["pixels_off"] == 0.0
