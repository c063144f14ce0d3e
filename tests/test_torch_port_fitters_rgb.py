"""The port's RGB fitters against the JAX package's on the CPU, in float64,
on the repo's hand data (the RGB fit's 200 wide × 199 high image with
k1 = −1, the three 200 × 283 views of the multi-view fit):

- ``MeshRGBFitterWithPose``: the first step and 3 steps held step by step
  (energies within 1e-9 relative; gradients to the vertices, quaternion,
  translation, color and lights within 1e-8 of their scale; the updated
  state within 1e-9), and its plan against the JAX core's kernel plan;
- ``MeshRGBFitterWithPoseMultiFrame``: 2 steps with the same bounds (the
  per-frame pose gradients and the shared ones summed over the frames), and
  its one plan for the three views against the JAX core's statistics
  maxed over the frames.

The trajectories are chaotic over tens of steps (the relative gap between
the two packages grows about tenfold a step from 1e-15), so only the
first steps are compared.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

import deodr_tpu
from deodr_tpu import ColoredTriMesh as JaxMesh
from deodr_tpu import read_obj as jax_read_obj
from deodr_tpu.geometry import transforms as jax_transforms
from deodr_tpu.mesh_fitter import MeshRGBFitterWithPose as JaxRGBFitter
from deodr_tpu.mesh_fitter import MeshRGBFitterWithPoseMultiFrame as JaxMultiFitter
from deodr_tpu_torch.examples import rgb_image_hand_fitting as rgb_ex
from deodr_tpu_torch.examples import rgb_multiview_hand as multi_ex
from deodr_tpu_torch.geometry import transforms
from test_torch_port_fitters import (
    HAND,
    _jax_stats,
    _port_and_jax_cores,
    assert_plans_equal,
    assert_results_close,
    assert_states_close,
    quiet,
    recorder,
    state_of,
)

GRADS = ("vertices_b", "quaternion_b", "translation_b", "mesh_color_b", "light_directional_b", "light_ambient_b")


def rgb_results(got, port: bool) -> dict:
    """An RGB step's fetched values by name."""
    if port:
        e, *grads, e_rigid, g_rigid = got
    else:
        e, grads, e_rigid, g_rigid = got
    return dict(energy_data=float(e), e_rigid=float(e_rigid), grad_rigidity=g_rigid,
                **{k: np.asarray(g) for k, g in zip(GRADS, grads)})


def jax_rgb_fitter():
    """The JAX package's RGB fitter as examples/rgb_image_hand_fitting.py builds it."""
    hand_image = np.asarray(PIL.Image.open(os.path.join(deodr_tpu.data_path, "hand.png"))).astype(np.double) / 255
    faces, vertices = jax_read_obj(HAND)
    mesh = JaxMesh(faces.copy(), vertices=vertices, nb_colors=3).subdivise(0)
    translation_init = np.mean(np.asarray(mesh.vertices), axis=0)
    fitter = JaxRGBFitter(np.asarray(mesh.vertices) - translation_init[None, :], mesh.faces,
                          default_color=np.array([0.4, 0.3, 0.25]),
                          default_light_directional=-np.array([0.1, 0.5, 0.4]), default_light_ambient=0.6,
                          update_lights=True, update_color=True, euler_init=np.array([0, 0, 0]),
                          translation_init=translation_init, cregu=1000)
    fitter.reset()
    fitter.set_image(hand_image, distortion=np.array([-1, 0, 0, 0, 0]))
    fitter.set_background_color(np.array([0.5, 0.6, 0.7]))
    return fitter


def jax_multi_fitter():
    """The JAX package's multi-frame fitter as examples/rgb_multiview_hand.py builds it."""
    images = [np.asarray(PIL.Image.open(f)).astype(np.double) / 255
              for f in sorted(glob.glob(os.path.join(deodr_tpu.data_path, "hand_multiview", "*.jpg")))]
    faces, vertices = jax_read_obj(HAND)
    n = len(images)
    fitter = JaxMultiFitter(vertices - np.mean(vertices, axis=0), faces,
                            default_color=np.array([0.4, 0.3, 0.25]) * 1.5,
                            default_light_directional=-np.array([0.1, 0.5, 0.4]), default_light_ambient=0.6,
                            euler_init=np.vstack([np.array([0, y, 0]) for y in np.linspace(-0.5, 0.5, n)]),
                            translation_init=np.tile(np.array([0, -0.2, 0.2])[None, :], [n, 1]), cregu=2000)
    fitter.reset()
    fitter.set_images(images)
    fitter.set_background_color(np.array([0, 0, 0]))
    return fitter


@pytest.fixture(scope="module")
def jax_rgb_run():
    fitter = jax_rgb_fitter()
    fetched = recorder(fitter)
    states, energies = [state_of(fitter)], []
    for _ in range(3):
        energies.append(quiet(fitter.step)[0])
        states.append(state_of(fitter))
    return states, [rgb_results(f, port=False) for f in fetched], energies


def gradient_recorder(fitter):
    """Wrap ``fitter.energy_data`` to keep each step's gradients and rigid
    energy (the multi-frame fitters keep them on themselves)."""
    got = []
    inner = fitter.energy_data

    def energy_data(vertices):
        out = inner(vertices)
        got.append(dict(energy_data=float(out[0]), e_rigid=float(fitter._e_rigid),
                        grad_rigidity=np.asarray(fitter._grad_rigidity), vertices_b=np.array(fitter._vertices_b),
                        quaternion_b=np.array(fitter.transform_quaternion_b),
                        translation_b=np.array(fitter.transform_translation_b),
                        mesh_color_b=np.array(fitter.mesh_color_b),
                        light_directional_b=np.array(fitter.light_directional_b),
                        light_ambient_b=float(fitter.light_ambient_b)))
        return out

    fitter.energy_data = energy_data
    return got


def test_rgb_example_inputs_match_jax():
    port, jaxf = rgb_ex.make_fitter(device="cpu"), jax_rgb_fitter()
    assert np.array_equal(port.mesh_image, jaxf.mesh_image)
    assert (port.width, port.height) == (jaxf.width, jaxf.height) == (200, 199)
    for name in ("extrinsic", "intrinsic", "distortion"):
        assert np.array_equal(getattr(port.camera, name), np.asarray(getattr(jaxf.camera, name)))
    assert_states_close(state_of(port), state_of(jaxf), tol=0)
    assert np.array_equal(port.background_color, jaxf.background_color)


def test_rgb_first_step_matches_jax(jax_rgb_run):
    states, want, energies = jax_rgb_run
    fitter = rgb_ex.make_fitter(device="cpu")
    fetched = recorder(fitter)
    energy, image, diff = quiet(fitter.step)
    assert image.shape == (199, 200, 3) and diff.shape == (199, 200)
    assert abs(energy - energies[0]) <= 1e-9 * energies[0]
    got = rgb_results(fetched[0], port=True)
    assert_results_close(got, want[0])
    assert all(np.abs(got[k]).max() > 0 for k in GRADS)
    assert_states_close(state_of(fitter), states[1])


def test_rgb_three_steps_match_jax(jax_rgb_run):
    states, want, energies = jax_rgb_run
    fitter = rgb_ex.make_fitter(device="cpu")
    fetched = recorder(fitter)
    for k in range(3):
        energy = quiet(fitter.step)[0]
        assert abs(energy - energies[k]) <= 1e-9 * energies[k], k
        assert_results_close(rgb_results(fetched[k], port=True), want[k])
        assert_states_close(state_of(fitter), states[k + 1])


def test_rgb_plan_matches_jax_kernel_plan(monkeypatch):
    port, jaxf = rgb_ex.make_fitter(device="cpu"), jax_rgb_fitter()
    core_p, core_j = _port_and_jax_cores(monkeypatch, port, jaxf)
    # the rotation is the identity at the start
    vt_j = jnp.asarray(jaxf.vertices) + jnp.asarray(jaxf.transform_translation)
    stats_j = _jax_stats(core_j, jaxf.camera, vt_j[None])
    with torch.no_grad():
        stats_p = core_p.stats(port.camera, torch.from_numpy(port.vertices + port.transform_translation)[None])
    assert np.array_equal(np.delete(stats_p.numpy(), 1), np.delete(stats_j, 1))
    assert_plans_equal(core_p.plan_from_stats(port.camera, stats_j), core_j.plan_from_stats(jaxf.camera, stats_j))


@pytest.fixture(scope="module")
def jax_multi_run():
    fitter = jax_multi_fitter()
    fetched = gradient_recorder(fitter)
    states, energies = [state_of(fitter)], []
    for _ in range(2):
        energies.append(quiet(fitter.step)[0])
        states.append(state_of(fitter))
    return states, fetched, energies


def test_multiframe_two_steps_match_jax(jax_multi_run):
    states, want, energies = jax_multi_run
    fitter = multi_ex.make_fitter(device="cpu")
    assert_states_close(state_of(fitter), states[0], tol=0)
    fetched = gradient_recorder(fitter)
    for k in range(2):
        energy, images, diffs = quiet(fitter.step)
        assert len(images) == 3 and images[0].shape == (283, 200, 3) and diffs[2].shape == (283, 200)
        assert abs(energy - energies[k]) <= 1e-9 * energies[k], k
        assert_results_close(fetched[k], want[k])
        assert_states_close(state_of(fitter), states[k + 1])
    assert fitter.core.n_runs == 2


def test_multiframe_plan_covers_every_view(monkeypatch):
    """One plan for the three views: the statistics maxed over the frames,
    as the JAX core's vmapped statistics, and its plan."""
    port, jaxf = multi_ex.make_fitter(device="cpu"), jax_multi_fitter()
    core_p, core_j = _port_and_jax_cores(monkeypatch, port, jaxf)
    q, t, v = jaxf.transform_quaternion, jaxf.transform_translation, jaxf.vertices
    vts_j = jax.vmap(lambda q_, t_: jax_transforms.qrot(jax_transforms.normalize(q_), jnp.asarray(v)) + t_)(
        jnp.asarray(q), jnp.asarray(t))
    stats_j = _jax_stats(core_j, jaxf.camera, vts_j)
    vts_p = transforms.qrot(transforms.normalize(torch.from_numpy(q)), torch.from_numpy(v)) + torch.from_numpy(t)[:, None]
    with torch.no_grad():
        per_view = [core_p.stats(port.camera, vts_p[i:i + 1]).numpy() for i in range(3)]
        stats_p = core_p.stats(port.camera, vts_p).numpy()
    assert np.array_equal(stats_p, np.max(per_view, axis=0))
    assert np.array_equal(np.delete(stats_p, 1), np.delete(stats_j, 1))
    assert abs(stats_p[1] - stats_j[1]) <= 1e-6 * stats_j[1]
    assert_plans_equal(core_p.plan_multi(port.camera, vts_p), core_j.plan_from_stats(jaxf.camera, stats_j))
