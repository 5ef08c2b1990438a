"""The port's entry points (`tinypathtracer_tpu_torch.entry`, the
counterpart of the JAX package's `__graft_entry__.py`) on the CPU:
entry()'s forward room frame against render_frame and JAX's
render_frame at the same config, the card by default, dryrun_multichip
on gloo ranks on the CPU with JAX's meshes and printed line, and no jax
import.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch

from tinypathtracer_tpu import RenderConfig as JaxConfig
from tinypathtracer_tpu.models.envlight import gradient_sky as jax_sky
from tinypathtracer_tpu.models.procedural import \
    sphere_grid_scene as jax_grid_scene
from tinypathtracer_tpu.render.renderer import \
    render_frame as jax_render_frame
from tinypathtracer_tpu_torch import RenderConfig
from tinypathtracer_tpu_torch.entry import dryrun_multichip, entry
from tinypathtracer_tpu_torch.render.renderer import render_frame

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX entry's config (__graft_entry__.py, without its deprecated
# tile_pixels)
CFG = dict(width=64, height=64, spp=2, max_depth=4, intersector="dense")
# pixels of the entry frame allowed beyond 1e-5 of JAX's (1 measured,
# twice that allowed)
JAX_PARTED_PIXELS = 2


@pytest.fixture(scope="module")
def frame():
    """entry(device="cpu")'s fn called on its example arguments: (the
    frame, the arguments)."""
    fn, args = entry(device="cpu")
    return fn(*args), args


def test_entry_frame_equals_render_frame(frame):
    """The radiance sum of the room at the JAX entry's config, on the
    CPU, equal bit for bit to render_frame's; finite and lit."""
    img, (scene, key) = frame
    assert scene.device.type == "cpu" and key.device.type == "cpu"
    assert tuple(img.shape) == (64, 64, 3)
    assert torch.isfinite(img).all() and float(img.mean()) > 0.01
    assert torch.equal(img, render_frame(scene, RenderConfig(**CFG), key))


def test_entry_frame_matches_jax(frame):
    """The same frame from the JAX package's render_frame on the same
    room (`sphere_grid_scene(2, 8, 16)`, a 16x32 sky) and key: every
    pixel within 1e-5 but at most JAX_PARTED_PIXELS. XLA fuses JAX's
    camera-ray arithmetic, the port does not, so a camera direction may
    differ by an ulp; at this key that sends one of the 8,192 paths
    (pixel row 61, column 18, sample 1; measured) to another face at a
    later bounce."""
    got = frame[0].numpy()
    flat = jax_grid_scene(2, 8, 16, env_radiance=jax_sky(16, 32))
    want = np.asarray(jax.jit(lambda s, k: jax_render_frame(
        s, JaxConfig(**CFG, megakernel=False), k))(flat,
                                                   jax.random.PRNGKey(0)))
    parted = np.abs(got - want).max(axis=-1) > 1e-5
    assert parted.sum() <= JAX_PARTED_PIXELS, np.argwhere(parted)


def test_entry_defaults_to_the_card():
    """entry() takes the card unless given device="cpu": without CUDA it
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()


def test_dryrun_defaults_to_the_card():
    """dryrun_multichip(n) takes the card unless given device="cpu":
    without CUDA it raises before it starts a rank."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun_multichip(2)


@pytest.mark.parametrize("n,mesh", [(2, "{'data': 1, 'sample': 2}"),
                                    (3, "{'data': 3, 'sample': 1}")])
def test_dryrun_multichip(capsys, n, mesh):
    """One sharded Adam step on n gloo ranks on the CPU: mesh (n/2, 2)
    for even n, (n, 1) for odd, a finite loss equal on every rank, JAX's
    line, and no kernel launched (the plain twins run on the CPU)."""
    out = dryrun_multichip(n, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    head = f"dryrun_multichip({n}): mesh={mesh} loss="
    assert line.startswith(head)
    assert np.isfinite(float(line[len(head):]))
    assert str(out["mesh"]) == mesh
    assert f"{out['loss']:.6f}" == line[len(head):]
    assert set(out["launches"].values()) == {0}


def test_entry_main_runs_the_dry_run():
    """python -m tinypathtracer_tpu_torch.entry multichip 2 --device cpu
    prints the dry run's line and exits 0."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "tinypathtracer_tpu_torch.entry",
         "multichip", "2", "--device", "cpu"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().startswith(
        "dryrun_multichip(2): mesh={'data': 1, 'sample': 2} loss=")


def test_entry_imports_no_jax():
    """Importing the entry module (and the port with it) loads neither
    jax, optax nor the JAX package."""
    code = ("import sys\n"
            "import tinypathtracer_tpu_torch.entry\n"
            "print([m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'optax', 'tinypathtracer_tpu')])\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
