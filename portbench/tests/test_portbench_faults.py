"""A run on the CPU at a tiny size, the card check skipped: sound, it
is correct; with each fault of portbench.faults planted under the timed
path, `correct` comes out false; the control (the reference with its
hit test in TF32 in the program's place) fails the comparison. The
pixels a window keeps are those a draw over every frame's image gives."""

import pytest
import torch

from portbench import compare, faults, readings, scenes
from portbench.kinds import frame
from portbench.tests import _tiny


def test_sound_run_is_correct():
    out = _tiny.execute()
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == {"pixels_off", "chunk_off_max"}


@pytest.mark.parametrize("fault", sorted(faults.FRAME))
def test_frame_fault_is_not_correct(fault):
    with faults.FRAME[fault]():
        out = _tiny.execute(frames=2)
    assert out["attempted"] == 2
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


def kept_image_selection(images, seed, per_chunk, rcfg):
    """The selection as a window that keeps every image makes it: the
    pixels, then each one's frame, drawn from one generator."""
    g = torch.Generator().manual_seed(seed % 2**63)
    px = frame.chunk_pixels(rcfg)
    starts = torch.arange(0, rcfg.n_pixels, px)
    sizes = torch.clamp(rcfg.n_pixels - starts, max=px)
    chunk = torch.arange(len(starts)).repeat_interleave(per_chunk)
    off = (torch.rand(len(chunk), generator=g, dtype=torch.float64)
           * sizes[chunk]).long()
    pix = starts[chunk] + torch.minimum(off, sizes[chunk] - 1)
    which = torch.randint(len(images), (len(pix),), generator=g)
    rows, cols = rcfg.height - 1 - pix // rcfg.width, pix % rcfg.width
    vals = torch.empty((len(pix), 3))
    for f in range(len(images)):
        sel = (which == f).nonzero()[:, 0]
        if len(sel):
            vals[sel] = images[f][rows[sel], cols[sel]]
    return which, pix, chunk, vals


@pytest.mark.parametrize("n_frames,seed", [(1, 5), (2, 2**31 + 7),
                                           (7, 9876543210987)])
def test_streaming_selection_equals_kept_images(n_frames, seed):
    """Frame by frame, keeping only the sampled pixels gives the same
    frames, pixels, chunks and values as the draw over kept images."""
    import tinypathtracer_tpu_torch as T

    c = _tiny.cell()
    rcfg = T.RenderConfig(**scenes.render_args(c.config))
    g = torch.Generator().manual_seed(n_frames)
    images = [torch.rand((rcfg.height, rcfg.width, 3), generator=g)
              for _ in range(n_frames)]
    want = kept_image_selection(images, seed, 16, rcfg)
    sampled = frame.Sampled(seed, 16, rcfg, torch.device("cpu"))
    for img in images:
        sampled.keep(img)
        del img
    got = sampled.pick()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(frame.sample_pixels(images, seed, 16, rcfg), want):
        assert torch.equal(a, b)
    assert sampled.failed() == 0


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf")])
def test_a_frame_with_a_value_not_finite_fails(bad):
    """A NaN or an infinity anywhere in a frame's image, sampled or not,
    counts that frame as failed."""
    import tinypathtracer_tpu_torch as T

    rcfg = T.RenderConfig(**scenes.render_args(_tiny.cell().config))
    sampled = frame.Sampled(3, 1, rcfg, torch.device("cpu"))
    images = torch.zeros((3, rcfg.height, rcfg.width, 3))
    images[1, 5, 7, 2] = bad
    for img in images:
        sampled.keep(img)
    assert sampled.failed() == 1
