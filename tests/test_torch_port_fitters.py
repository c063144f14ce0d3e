"""The port's fitting layer (deodr_tpu_torch.mesh_fitter and the geometry
it needs) against the JAX package on the CPU, in float64, on the repo's
hand data:

- ``normalize``, ``qrot`` (single and batched) and their gradients, the
  distorted projection (k1 = ±1, the fitters' lenses) and its gradient:
  1e-12;
- ``laplacian_apply`` and ``LaplacianRigidEnergy.evaluate`` on the hand:
  1e-10 relative; ``loop_subdivision`` once and twice: faces equal,
  vertices and colors within 1e-12;
- ``MeshDepthFitter``: the first step and 3 steps held step by step
  (energies within 1e-9 relative, gradients within 1e-8 of their scale,
  the updated state within 1e-9); its plan against the JAX core's kernel
  plan (``default_impl`` patched to "pallas" in the test only), the
  hysteresis, a forced capacity overflow; state carried over from a JAX
  fitter; checkpoints;
- ``MeshDepthFitterEnergy``: energy and gradient at the start against the
  JAX total energy there (1e-9 relative, 1e-8 of scale; the JAX depth
  fitter's first step evaluates it), and L-BFGS below 0.6×
  the first energy within 8 steps (the bar of tests/test_fitters_more.py);
- the tie rules of ``jnp.clip`` and ``jnp.maximum`` (a gradient of 0.5);
- the entry points default to ``cuda`` (that they import no JAX is in
  test_torch_port_render.py's import test).

The RGB and multi-view fitters are in test_torch_port_fitters_rgb.py.
"""

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deodr_tpu
import deodr_tpu.ops.render as jax_render_module
import torch_port_scenes  # noqa: F401  (one PyTorch thread a worker)
from deodr_tpu import ColoredTriMesh as JaxMesh
from deodr_tpu import read_obj as jax_read_obj
from deodr_tpu.camera import Camera as JaxCamera
from deodr_tpu.geometry import transforms as jax_transforms
from deodr_tpu.geometry.energy import LaplacianRigidEnergy as JaxRigid
from deodr_tpu.mesh_fitter import MeshDepthFitter as JaxDepthFitter
from deodr_tpu.mesh_fitter import _FitterRenderCore as JaxCore
from deodr_tpu_torch import checkpoint
from deodr_tpu_torch import mesh_fitter as port_fitter
from deodr_tpu_torch.camera import Camera
from deodr_tpu_torch.examples import depth_image_hand_fitting as depth_ex
from deodr_tpu_torch.examples import rgb_image_hand_fitting as rgb_ex
from deodr_tpu_torch.examples import rgb_multiview_hand as multi_ex
from deodr_tpu_torch.geometry import transforms
from deodr_tpu_torch.geometry.energy import LaplacianRigidEnergy
from deodr_tpu_torch.geometry.mesh import ColoredTriMesh
from deodr_tpu_torch.scene import Scene3D

HAND = os.path.join(deodr_tpu.data_path, "hand.obj")
STATE_KEYS = checkpoint._FITTER_STATE_KEYS
TILING_FIELDS = ("tile_h", "tile_w", "triangle_capacity", "edge_capacity", "drawn_capacity", "edge_tile_h",
                 "super_ty", "super_tx", "super_capacity")


def rel(a, b) -> float:
    """max |a − b| over the larger of max |b| and the smallest positive
    float (the scale of b)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), np.finfo(np.float64).tiny))


def quiet(fn, *args, **kwargs):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def state_of(fitter) -> dict:
    return {k: np.array(getattr(fitter, k)) for k in STATE_KEYS if hasattr(fitter, k)}


def assert_states_close(got: dict, want: dict, tol=1e-9):
    assert set(got) == set(want)
    for k in want:
        scale = max(1.0, float(np.abs(want[k]).max()))
        assert np.abs(np.asarray(got[k], np.float64) - want[k]).max() <= tol * scale, k


def recorder(fitter):
    """Wrap ``fitter.core.planned_step`` to keep what each step fetched."""
    fetched = []
    inner = fitter.core.planned_step

    def planned_step(*args, **kwargs):
        out, got = inner(*args, **kwargs)
        fetched.append(got)
        return out, got

    fitter.core.planned_step = planned_step
    return fetched


def depth_results(got, port: bool) -> dict:
    """A depth step's fetched values by name (the JAX core fetches
    (energy_data, grads, e_rigid, grad_rigidity))."""
    if port:
        e, gv, gq, gt, e_rigid, g_rigid = got
    else:
        e, (gv, gq, gt), e_rigid, g_rigid = got
    return dict(energy_data=float(e), e_rigid=float(e_rigid), vertices_b=gv, quaternion_b=gq, translation_b=gt,
                grad_rigidity=g_rigid)


def assert_results_close(got: dict, want: dict):
    """Energies within 1e-9 relative, gradients within 1e-8 of their scale;
    the scale at least 1 (the rigid energy and its gradient are zero up to
    rounding at the start)."""
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1.0)
        assert np.abs(np.asarray(got[k]) - want[k]).max() <= (1e-9 if np.ndim(want[k]) == 0 else 1e-8) * scale, k


def jax_depth_fitter():
    """The JAX package's depth fitter as examples/depth_image_hand_fitting.py builds it."""
    depth_image = np.fliplr(np.fromfile(os.path.join(deodr_tpu.data_path, "depth.bin"), dtype=np.float32)
                            .reshape(240, 320).astype(np.float64))
    depth_image = depth_image[20:-20, 60:-60]
    max_depth = 450
    depth_image[depth_image == 0] = max_depth
    depth_image = depth_image / max_depth
    faces, vertices = jax_read_obj(HAND)
    mesh = JaxMesh(faces.copy(), vertices=vertices, nb_colors=0).subdivise(0)
    fitter = JaxDepthFitter(np.asarray(mesh.vertices), mesh.faces, np.array([0.1, 0.1, 0.1]), np.zeros(3), cregu=1000)
    fitter.set_image(depth_image, focal=241, distortion=np.array([1, 0, 0, 0, 0]))
    fitter.set_max_depth(1)
    fitter.set_depth_scale(110 / max_depth)
    return fitter


@pytest.fixture(scope="module")
def jax_depth_run():
    """Three steps of the JAX depth fitter: (states before each step and
    after the last, fetched values of each step, energies)."""
    fitter = jax_depth_fitter()
    fetched = recorder(fitter)
    states, energies = [state_of(fitter)], []
    for _ in range(3):
        energies.append(quiet(fitter.step)[0])
        states.append(state_of(fitter))
    return states, [depth_results(f, port=False) for f in fetched], energies


def port_depth_fitter(**kwargs):
    return depth_ex.make_fitter(device="cpu", **kwargs)


def hand_arrays():
    faces, vertices = jax_read_obj(HAND)
    return faces, vertices


# ------------------------------------------------------------- transforms


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_normalize_and_qrot_match_jax(batched):
    rng = np.random.RandomState(0)
    q = rng.randn(3, 4) if batched else rng.randn(4)
    v = rng.randn(50, 3)
    want = np.asarray(jax.jit(lambda q_, v_: jax_transforms.qrot(jax_transforms.normalize(q_), v_))(
        jnp.asarray(q), jnp.asarray(v)))
    got = transforms.qrot(transforms.normalize(torch.from_numpy(q)), torch.from_numpy(v)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-12


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_transform_gradients_match_jax(batched):
    """Gradients of Σ w·qrot(normalize(q), v) with respect to q and v."""
    rng = np.random.RandomState(1)
    q = rng.randn(3, 4) if batched else rng.randn(4)
    v = rng.randn(40, 3)
    w = rng.randn(*((3, 40, 3) if batched else (40, 3)))

    def f(q_, v_):
        return jnp.sum(jnp.asarray(w) * jax_transforms.qrot(jax_transforms.normalize(q_), v_))

    gq_j, gv_j = jax.jit(jax.grad(f, argnums=(0, 1)))(jnp.asarray(q), jnp.asarray(v))
    q_t, v_t = (torch.from_numpy(a).requires_grad_(True) for a in (q, v))
    (torch.from_numpy(w) * transforms.qrot(transforms.normalize(q_t), v_t)).sum().backward()
    assert np.abs(q_t.grad.numpy() - np.asarray(gq_j)).max() <= 1e-12
    assert np.abs(v_t.grad.numpy() - np.asarray(gv_j)).max() <= 1e-12


def test_cross2_and_finite_differences_match_jax():
    rng = np.random.RandomState(2)
    u, v = rng.randn(7, 2), rng.randn(7, 2)
    assert np.array_equal(transforms.cross2(torch.from_numpy(u), torch.from_numpy(v)).numpy(),
                          np.asarray(jax_transforms.cross2(jnp.asarray(u), jnp.asarray(v))))

    def func(x):
        return np.array([np.sin(x[0]) * x[1], x[1] ** 3 + x[2], np.exp(x[2])])

    x = rng.randn(3)
    jac = transforms.jacobian_finite_differences(func, x)
    assert np.array_equal(jac, jax_transforms.jacobian_finite_differences(func, x))
    exact = np.array([[np.cos(x[0]) * x[1], np.sin(x[0]), 0], [0, 3 * x[1] ** 2, 1], [0, 0, np.exp(x[2])]])
    assert transforms.check_jacobian_finite_differences(exact, func, x) < 1e-4
    with pytest.raises(AssertionError):
        transforms.check_jacobian_finite_differences(exact + 1.0, func, x)


@pytest.mark.parametrize("k1", [1.0, -1.0])
def test_distorted_projection_and_gradient_match_jax(k1):
    """The fitters' camera with k1 = +1 (depth fit) and −1 (RGB fit) on
    the hand's vertices: points, depths and the gradient of a weighted sum
    of both with respect to the vertices, within 1e-12."""
    _, vertices = hand_arrays()
    center = vertices.mean(axis=0) + np.array([-0.5, 0, 5]) * np.max(np.std(vertices, axis=0))
    rot = np.array([[1.0, 0, 0], [0, -1, 0], [0, 0, -1]])
    args = dict(extrinsic=np.column_stack((rot, -rot.T.dot(center))),
                intrinsic=np.array([[241.0, 0, 100], [0, 241, 100], [0, 0, 1]]),
                distortion=np.array([k1, 0, 0, 0, 0]), height=200, width=200)
    rng = np.random.RandomState(3)
    w_ij, w_d = rng.randn(len(vertices), 2), rng.randn(len(vertices))

    def f(v):
        ij, d = JaxCamera(**args).project_points(v)
        return jnp.sum(ij * w_ij) + jnp.sum(d * w_d), (ij, d)

    (_, (ij_j, d_j)), g_j = jax.jit(jax.value_and_grad(f, has_aux=True))(jnp.asarray(vertices))
    v_t = torch.from_numpy(vertices).requires_grad_(True)
    ij, d = Camera(**args).project_points(v_t)
    ((ij * torch.from_numpy(w_ij)).sum() + (d * torch.from_numpy(w_d)).sum()).backward()
    assert np.abs(ij.detach().numpy() - np.asarray(ij_j)).max() <= 1e-12 * np.abs(np.asarray(ij_j)).max()
    assert np.abs(d.detach().numpy() - np.asarray(d_j)).max() <= 1e-12
    assert rel(v_t.grad.numpy(), g_j) <= 1e-12


# ------------------------------------------------- Laplacian, energy, subdivision


def _hand_meshes(colors=None):
    faces, vertices = hand_arrays()
    kw = dict(colors=colors) if colors is not None else dict(nb_colors=0)
    return ColoredTriMesh(faces, torch.from_numpy(vertices), **kw), JaxMesh(faces, vertices, **kw), vertices


def test_laplacian_apply_matches_jax():
    mesh_p, mesh_j, vertices = _hand_meshes()
    x = np.random.RandomState(4).randn(*vertices.shape)
    want = np.asarray(mesh_j.adjacencies.laplacian_apply(jnp.asarray(x)))
    got = mesh_p.adjacencies.laplacian_apply(torch.from_numpy(x)).numpy()
    assert rel(got, want) <= 1e-10


def test_rigid_energy_matches_jax():
    """Energy, gradient and approximate Hessian product on the hand with
    perturbed vertices, within 1e-10 relative; the energy's autograd
    gradient is the gradient it returns."""
    mesh_p, mesh_j, vertices = _hand_meshes()
    rng = np.random.RandomState(5)
    v = vertices + 0.01 * rng.randn(*vertices.shape)
    x = rng.randn(*vertices.shape)
    e_j, g_j, hmv_j = JaxRigid(mesh_j, vertices, 1000.0).evaluate(jnp.asarray(v))
    v_t = torch.from_numpy(v).requires_grad_(True)
    e_p, g_p, hmv_p = LaplacianRigidEnergy(mesh_p, vertices, 1000.0).evaluate(v_t)
    assert abs(e_p.item() - float(e_j)) <= 1e-10 * abs(float(e_j))
    assert rel(g_p.detach().numpy(), g_j) <= 1e-10
    assert rel(hmv_p(torch.from_numpy(x)).numpy(), hmv_j(jnp.asarray(x))) <= 1e-10
    e_p.backward()
    assert rel(v_t.grad.numpy(), g_p.detach().numpy()) <= 1e-10


def test_rigid_energy_refuses_two_components():
    faces = np.array([[0, 1, 2], [3, 4, 5]])
    vertices = np.random.RandomState(6).randn(6, 3)
    with pytest.raises(ValueError, match="more than one connected component") as e_port:
        LaplacianRigidEnergy(ColoredTriMesh(faces, vertices, nb_colors=0), vertices, 1.0)
    with pytest.raises(ValueError) as e_jax:
        JaxRigid(JaxMesh(faces, vertices, nb_colors=0), vertices, 1.0)
    assert str(e_port.value) == str(e_jax.value)


@pytest.mark.parametrize("n_iter", [1, 2])
def test_loop_subdivision_matches_jax(n_iter):
    colors = np.random.RandomState(7).rand(526, 3)
    mesh_p, mesh_j, _ = _hand_meshes(colors)
    sub_p, sub_j = mesh_p.subdivise(n_iter), mesh_j.subdivise(n_iter)
    assert np.array_equal(sub_p.faces, sub_j.faces)
    assert sub_p.nb_faces == 1048 * 4**n_iter
    assert np.abs(sub_p.vertices.numpy() - np.asarray(sub_j.vertices)).max() <= 1e-12
    assert np.abs(sub_p.vertices_colors.numpy() - np.asarray(sub_j.vertices_colors)).max() <= 1e-12
    assert mesh_p.subdivise(0) is mesh_p


def test_subdivision_refuses_a_textured_mesh():
    faces, vertices = hand_arrays()
    kw = dict(faces_uv=faces, uv=np.zeros((len(vertices), 2)), texture=np.zeros((4, 4, 3)))
    with pytest.raises(ValueError) as e_port:
        ColoredTriMesh(faces, vertices, **kw).subdivise(1)
    with pytest.raises(ValueError) as e_jax:
        JaxMesh(faces, vertices, **kw).subdivise(1)
    assert str(e_port.value) == str(e_jax.value) == "Textured mesh not supported yet in subdivision."


# ------------------------------------------------------------ depth fitter


def test_depth_example_inputs_match_jax():
    """The port's example builds the JAX example's fitter: image, camera,
    mesh, initial state."""
    port, jaxf = port_depth_fitter(), jax_depth_fitter()
    assert np.array_equal(port.mesh_image, jaxf.mesh_image)
    assert (port.width, port.height) == (jaxf.width, jaxf.height) == (200, 200)
    for name in ("extrinsic", "intrinsic", "distortion"):
        assert np.array_equal(getattr(port.camera, name), np.asarray(getattr(jaxf.camera, name)))
    assert np.array_equal(port.mesh.faces, jaxf.mesh.faces)
    assert_states_close(state_of(port), state_of(jaxf), tol=0)
    assert (port.max_depth, port.depth_scale) == (jaxf.max_depth, jaxf.depth_scale)


def test_depth_first_step_matches_jax(jax_depth_run):
    states, want, energies = jax_depth_run
    fitter = port_depth_fitter()
    fetched = recorder(fitter)
    energy, depth, diff = quiet(fitter.step)
    assert depth.shape == (200, 200) and diff.shape == (200, 200)
    assert abs(energy - energies[0]) <= 1e-9 * energies[0]
    assert_results_close(depth_results(fetched[0], port=True), want[0])
    assert_states_close(state_of(fitter), states[1])


def test_depth_three_steps_match_jax(jax_depth_run):
    states, want, energies = jax_depth_run
    fitter = port_depth_fitter()
    fetched = recorder(fitter)
    for k in range(3):
        energy = quiet(fitter.step)[0]
        assert abs(energy - energies[k]) <= 1e-9 * energies[k], k
        assert_results_close(depth_results(fetched[k], port=True), want[k])
        assert_states_close(state_of(fitter), states[k + 1])
    assert fitter.iter == 3 and fitter.core.n_runs == 3


def test_state_carried_from_jax_continues_its_trajectory(jax_depth_run):
    """A JAX fitter's state after 2 steps, handed to a fresh port fitter
    with set_fitter_state: the port's next step is the JAX fitter's third."""
    states, want, energies = jax_depth_run
    fitter = port_depth_fitter()
    checkpoint.set_fitter_state(fitter, states[2])
    assert fitter.iter == 2
    fetched = recorder(fitter)
    energy = quiet(fitter.step)[0]
    assert abs(energy - energies[2]) <= 1e-9 * energies[2]
    assert_results_close(depth_results(fetched[0], port=True), want[2])
    assert_states_close(state_of(fitter), states[3])


def test_checkpoint_round_trip(tmp_path):
    fitter = port_depth_fitter()
    quiet(fitter.step)
    path = str(tmp_path / "sub" / "depth.npz")
    checkpoint.save_fitter(fitter, path)
    assert sorted(os.listdir(tmp_path / "sub")) == ["depth.npz"]
    other = port_depth_fitter()
    checkpoint.load_fitter(other, path)
    assert_states_close(state_of(other), state_of(fitter), tol=0)
    assert other.iter == 1
    with np.load(path) as data:
        assert sorted(data.files) == sorted(state_of(fitter))
    with pytest.raises(KeyError, match="not fitter state keys"):
        checkpoint.set_fitter_state(other, {"vertices": fitter.vertices, "learning_rate": 1.0})


def _port_and_jax_cores(monkeypatch, port, jaxf):
    """The port fitter's core and a fresh JAX core of the same mesh whose
    plans are the kernel route's (``default_impl`` patched to "pallas")."""
    monkeypatch.setattr(jax_render_module, "default_impl", lambda: "pallas")
    return port.core, JaxCore(jaxf.mesh, sigma=1.0)


def _jax_stats(core, camera, verts_batch):
    return np.asarray(jax.device_get(core.stats_dispatch(camera, verts_batch))).max(axis=0)


def assert_plans_equal(got, want):
    cap_p, tiling_p = got
    cap_j, tiling_j = want
    assert cap_p == cap_j
    assert (tiling_p is None) == (tiling_j is None)
    if tiling_j is not None:
        assert {f: getattr(tiling_p, f) for f in TILING_FIELDS} == {f: getattr(tiling_j, f) for f in TILING_FIELDS}


def test_depth_plan_matches_jax_kernel_plan(monkeypatch):
    """The statistics (counts exact, the median within float32 rounding)
    and the plan: 128-wide tiles, the same tile heights and capacities."""
    port, jaxf = port_depth_fitter(), jax_depth_fitter()
    core_p, core_j = _port_and_jax_cores(monkeypatch, port, jaxf)
    stats_j = _jax_stats(core_j, jaxf.camera, jaxf._transformed_vertices()[None])
    with torch.no_grad():
        stats_p = core_p.stats(port.camera, port._transformed_vertices()[None]).numpy()
    assert stats_p.shape == stats_j.shape == (17,)
    assert np.array_equal(np.delete(stats_p, 1), np.delete(stats_j, 1))
    assert abs(stats_p[1] - stats_j[1]) <= 1e-6 * stats_j[1]
    plan_p = core_p.plan_from_stats(port.camera, stats_j)
    assert_plans_equal(plan_p, core_j.plan_from_stats(jaxf.camera, stats_j))
    assert plan_p[1].tile_w == 128 and plan_p[1].tile_h in (8, 16, 48)
    assert plan_p[1].edge_tile_h in (0, 8, 16, 32, 48)
    assert core_p.plan_fits(port.camera, stats_p, *plan_p)


def test_plan_hysteresis_matches_jax(monkeypatch):
    """Shrinking occupancies keep the last plan (it still fits and is at
    most 4× too large); growth beyond a capacity replaces it; each plan the
    JAX core's."""
    port, jaxf = port_depth_fitter(), jax_depth_fitter()
    core_p, core_j = _port_and_jax_cores(monkeypatch, port, jaxf)
    stats = _jax_stats(core_j, jaxf.camera, jaxf._transformed_vertices()[None])
    first = core_p.plan_from_stats(port.camera, stats)
    assert_plans_equal(first, core_j.plan_from_stats(jaxf.camera, stats))
    smaller = stats.copy()
    smaller[2:12] = np.floor(smaller[2:12] * 0.6)
    smaller[0] = np.floor(smaller[0] * 0.6)
    kept = core_p.plan_from_stats(port.camera, smaller)
    assert kept == first and core_p.plan_guess(port.camera) == first
    assert_plans_equal(kept, core_j.plan_from_stats(jaxf.camera, smaller))
    larger = stats.copy()
    larger[2:12] = larger[2:12] * 3
    replaced = core_p.plan_from_stats(port.camera, larger)
    assert replaced[1].triangle_capacity > first[1].triangle_capacity
    assert_plans_equal(replaced, core_j.plan_from_stats(jaxf.camera, larger))
    assert not core_p.plan_fits(port.camera, larger, *first)


def test_forced_capacity_overflow_warns_and_replans(jax_depth_run):
    """With a triangle capacity lowered by hand (and the statistics' check
    bypassed), the every-step capacity check must warn, replan and re-run:
    the step's energy is the JAX fitter's."""
    _, _, energies = jax_depth_run
    fitter = port_depth_fitter()
    quiet(fitter.step)
    key = fitter.core._plan_ctx(fitter.camera)[1]
    cap, tiling = fitter.core.plans[key]
    fitter.core.plans[key] = (cap, tiling._replace(triangle_capacity=8))
    fitter.core.plan_fits = lambda *args: True
    fitter.core.check_every = 1
    with pytest.warns(UserWarning, match=r"overflowed \(solid tile bin: occupancy \d+ exceeds capacity 8\); replanning"):
        energy = quiet(fitter.step)[0]
    assert fitter.core.n_runs == 3
    assert abs(energy - energies[1]) <= 1e-9 * energies[1]
    assert fitter.core.plan_guess(fitter.camera)[1].triangle_capacity > 8


# --------------------------------------------------- the L-BFGS energy module


def test_lbfgs_energy_and_gradient_match_jax(jax_depth_run):
    """The energy module at the start against the JAX total energy there:
    the data energy of the centred vertices (the JAX depth fitter's first
    step evaluates exactly that, with ``jax.value_and_grad``) plus the
    rigid energy of the vertices, which is 0 at the start. The gradient to
    the vertices is the data gradient with its mean taken out (the
    centring), the quaternion's and translation's are the data's."""
    _, want, _ = jax_depth_run
    port = port_depth_fitter(optimizer="lbfgs")
    with torch.no_grad():
        plan = port.core.plan(port.camera, port._transformed_vertices())
    module = port_fitter.DepthFitEnergy(port)
    module.plan = plan
    e_p = module()
    e_p.backward()
    g_v = want[0]["vertices_b"] - want[0]["vertices_b"].mean(axis=0)
    assert abs(e_p.item() - want[0]["energy_data"]) <= 1e-9 * want[0]["energy_data"]
    assert rel(module.vertices.grad.numpy(), g_v) <= 1e-8
    assert rel(module.quaternion.grad.numpy(), want[0]["quaternion_b"]) <= 1e-8
    assert rel(module.translation.grad.numpy(), want[0]["translation_b"]) <= 1e-8
    assert module.n_evaluations == 1


def test_lbfgs_fit_converges():
    fitter = port_depth_fitter(optimizer="lbfgs")
    energies = [quiet(fitter.step) for _ in range(8)]
    assert energies[-1] < 0.6 * energies[0], energies
    assert fitter.iter == 8 and fitter.energy.n_evaluations >= 8
    assert fitter.vertices.dtype == np.float64 and fitter.vertices.shape == (526, 3)


# ------------------------------------------------------------ tie rules


def test_clip_gives_jax_tie_gradient():
    """A depth pixel exactly at max_depth (1, the background's value) or at
    0 gets half the gradient, as jnp.clip gives."""
    x = np.array([-0.5, 0.0, 0.3, 1.0, 1.7])
    w = np.array([1.0, 2.0, 3.0, 4.0, 5.0])
    g_j = np.asarray(jax.grad(lambda v: jnp.sum(jnp.clip(v, 0.0, 1.0) * w))(jnp.asarray(x)))
    x_t = torch.from_numpy(x).requires_grad_(True)
    out = port_fitter.clip(x_t, 0.0, 1.0)
    (out * torch.from_numpy(w)).sum().backward()
    assert np.array_equal(out.detach().numpy(), np.clip(x, 0, 1))
    assert np.array_equal(x_t.grad.numpy(), g_j)
    assert np.array_equal(g_j, [0.0, 1.0, 3.0, 2.0, 0.0])


def test_luminosity_gives_jax_tie_gradient():
    """A light orthogonal to every vertex normal: zero directional
    luminosity, where jnp.maximum gives half the gradient (the RGB fitters
    take their luminosity from Scene3D)."""
    faces = np.array([[0, 1, 2], [0, 2, 3]])
    vertices = np.array([[0.0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]])
    light = np.array([1.0, 0.0, 0.0])
    mesh_j = JaxMesh(faces, vertices, nb_colors=3)

    def lum_j(ld):
        adj = mesh_j.adjacencies
        normals = adj.compute_vertex_normals(adj.compute_face_normals(jnp.asarray(vertices)))
        return jnp.sum(jnp.maximum(0.0, -jnp.sum(normals * ld, axis=1)) + 0.3)

    g_j = np.asarray(jax.jit(jax.grad(lum_j))(jnp.asarray(light)))
    ld = torch.from_numpy(light).requires_grad_(True)
    scene = Scene3D(sigma=1.0, device="cpu")  # the RGB fitters' buffers take its luminosity
    scene.set_mesh(ColoredTriMesh(faces, torch.from_numpy(vertices), nb_colors=3))
    lum = scene._luminosity(torch.from_numpy(vertices), ld, 0.3)
    lum.sum().backward()
    assert np.array_equal(lum.detach().numpy(), np.full(4, 0.3))
    assert np.array_equal(ld.grad.numpy(), g_j)
    assert np.abs(g_j).max() == 2.0  # 4 vertices × 0.5 × |n_z| = 1


# ------------------------------------------------ devices and imports


@pytest.mark.parametrize("make", [
    lambda: depth_ex.make_fitter(),
    lambda: depth_ex.make_fitter(optimizer="lbfgs"),
    lambda: rgb_ex.make_fitter(),
    lambda: multi_ex.make_fitter(),
], ids=["depth", "lbfgs", "rgb", "multiview"])
def test_fitters_default_to_cuda(make):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        make()


def test_multiframe_device_mesh_is_scale_out():
    """None keeps the sequential fitter; a mesh needs a 'views' axis (the
    sharded steps: tests/test_torch_port_parallel.py)."""
    fitter = multi_ex.make_fitter(device="cpu")
    fitter.set_device_mesh(None)
    with pytest.raises(ValueError, match="'views' axis"):
        fitter.set_device_mesh(object())
