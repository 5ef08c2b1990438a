"""Faults planted under the program's timed path, for the tests that
see `correct` come out false and for the readings that show the limits
catch them at the cell's size (readings.py). Each is a context manager
that patches the port while it is open.

Frame cells:
  * "stale": every frame after the first returns the first frame's
    image (a step that returns its state unchanged);
  * "half_batch": half of each pixel's samples left out, the mean taken
    over the rest;
  * "altered": the radiance of every fifth lane raised by 0.05 where
    the bounce loop produces it;
  * "chunk_zeroed": the middle chunk of the frame left black.
Each of these makes `correct` false. `SMALL` holds a fault that the
limits let pass, read and reported by readings.py all the same:
  * "ragged_zeroed": the ragged last chunk of the frame left black. In
    the Cornell cell that chunk is the image's top 22 rows, 18 of them
    beyond the box and black, so the fault changes ~0.05 % of a frame's
    pixels: 0-3 of the chunk's 64 samples.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def patched(owner, name, wrap):
    orig = getattr(owner, name)
    setattr(owner, name, wrap(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def _stale():
    import tinypathtracer_tpu_torch as T

    def wrap(orig):
        first = {}

        def render(self, scene, key):
            if id(self) not in first:
                first[id(self)] = orig(self, scene, key)
            return first[id(self)].clone()
        return render
    return patched(T.Renderer, "render", wrap)


def _half_batch():
    from tinypathtracer_tpu_torch.render import renderer as rend

    def wrap(orig):
        def half(state, cfg, pix, key, spp=None, sample_offset=0):
            spp = cfg.spp if spp is None else spp
            return orig(state, cfg, pix, key, max(1, spp // 2),
                        sample_offset) * (spp / max(1, spp // 2))
        return half
    return patched(rend, "render_pixel_ids", wrap)


@contextlib.contextmanager
def _on_lanes(change):
    """The bounce loop's radiance [lanes, 3] of each chunk passed
    through change(rad, first pixel of the chunk, cfg)."""
    from tinypathtracer_tpu_torch.render import renderer as rend

    seen = {}

    def lane_rays(orig):
        def rays(scene, cfg, pix, *args, **kwargs):
            seen.update(first=int(pix[0]), cfg=cfg)
            return orig(scene, cfg, pix, *args, **kwargs)
        return rays

    def paths(orig):
        def traced(*args, **kwargs):
            return change(orig(*args, **kwargs).clone(), seen["first"],
                          seen["cfg"])
        return traced

    with patched(rend, "lane_rays", lane_rays), \
            patched(rend, "trace_paths_mega", paths), \
            patched(rend, "trace_paths", paths):
        yield


def _altered():
    def change(rad, first, cfg):
        rad[::5] += 0.05
        return rad
    return _on_lanes(change)


def _zeroed(which):
    def change(rad, first, cfg):
        px = max(1, min(cfg.n_pixels, cfg.rays_per_dispatch // cfg.spp))
        n_chunks = -(-cfg.n_pixels // px)
        target = (n_chunks // 2 if which == "middle" else n_chunks - 1) * px
        return rad * 0.0 if first == target else rad
    return _on_lanes(change)


FRAME = {"stale": _stale, "half_batch": _half_batch, "altered": _altered,
         "chunk_zeroed": lambda: _zeroed("middle")}
SMALL = {"ragged_zeroed": lambda: _zeroed("ragged")}
