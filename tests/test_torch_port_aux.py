"""The port's auxiliaries against the JAX package on the CPU:

- (f) ``deodr_tpu_torch.profiling``: the report's format (the JAX
  report's, line for line), the Chrome-trace ingestion on a small synthetic
  trace with kernel, copy and host events (overlapping device intervals
  counted once in the busy time), and an empty table on the CPU, as JAX's;
- (g) the Adam depth fit (``examples/optax_fitting.py``): its first 5
  energies against JAX's ``run(max_iter=5)`` within 1e-9 relative, and
  the 30-iteration contract of test_optax_fitting_converges (the last
  energy below 0.85 × the first);
- (h) the batch (``render_scene_batch``): test_vmapped_batch_rendering's
  scene (np.random.seed(11), 5 triangles, 48², 4 perturbed ij), images and
  the gradient of sum(images²) against ``jax.vmap(render_scene)`` in
  float64, within 1e-9 (of scale for the gradient), and its checks;
- (i) the viewer (``examples/mesh_viewer.py``): the five checks of
  tests/test_viewer.py on the port's viewer, and one frame against the JAX
  viewer's at the same camera: uint8 frames at most 1 level apart (a value
  within rounding of a level boundary may round either way).
"""

import dataclasses
import gzip
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deodr_tpu_torch.geometry.primitives import octahedron_mesh
from deodr_tpu_torch.profiling import DeviceProfile, device_profile

# ------------------------------------------------------------ (f) profiling


def test_report_format_matches_jax():
    from deodr_tpu.profiling import DeviceProfile as JaxProfile

    tables = dict(times={"raster_fwd_kernel": 1234.5, "edge_bwd_kernel": 88.25, "memset": 0.5},
                  counts={"raster_fwd_kernel": 10, "edge_bwd_kernel": 3, "memset": 7}, total_us=1400.0)
    port, ref = DeviceProfile(), JaxProfile()
    for p in (port, ref):
        for k, v in tables.items():
            setattr(p, k, v)
    for top, min_us in ((15, 1.0), (1, 1.0), (15, 0.1)):
        assert port.report(top, min_us) == ref.report(top, min_us)
    assert port.report().splitlines() == ["device total: 1400 us", "    1234.5 us  x   10  raster_fwd_kernel",
                                          "      88.2 us  x    3  edge_bwd_kernel"]


def test_ingest_keeps_device_events_of_a_chrome_trace(tmp_path):
    def x(name, cat, ts, dur, pid=0):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": pid, "tid": 7}

    events = [
        x("aten::add", "cpu_op", 0.0, 50.0, pid=1234),
        x("cudaLaunchKernel", "cuda_runtime", 1.0, 4.0, pid=1234),
        x("raster_fwd_kernel", "kernel", 10.0, 5.0),
        x("raster_fwd_kernel", "kernel", 30.0, 5.0),
        x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 12.0, 6.0),  # overlaps the first kernel by 3 us
        x("Memset (Device)", "gpu_memset", 40.0, 1.5),
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}},
    ]
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": events[:4]}))
    (tmp_path / "sub").mkdir()
    with gzip.open(tmp_path / "sub" / "other.json.gz", "wt") as f:  # a gzipped trace in a subfolder is read too
        json.dump({"traceEvents": events[4:]}, f)
    prof = DeviceProfile()
    prof._ingest(str(tmp_path))
    assert prof.times == {"raster_fwd_kernel": 10.0, "Memcpy HtoD (Pageable -> Device)": 6.0, "Memset (Device)": 1.5}
    assert prof.counts == {"raster_fwd_kernel": 2, "Memcpy HtoD (Pageable -> Device)": 1, "Memset (Device)": 1}
    assert prof.total_us == 5.0 + 3.0 + 5.0 + 1.5  # [10, 18) + [30, 35) + [40, 41.5)
    assert [e[2] for e in prof.events] == ["raster_fwd_kernel", "Memcpy HtoD (Pageable -> Device)",
                                           "raster_fwd_kernel", "Memset (Device)"]


def test_device_profile_is_empty_on_the_cpu(tmp_path):
    from deodr_tpu.profiling import device_profile as jax_device_profile

    with device_profile(str(tmp_path / "port"), keep=True) as prof:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    assert os.path.exists(tmp_path / "port" / "trace.json")
    with jax_device_profile() as ref:
        jax.block_until_ready(jax.jit(lambda a: (a @ a).sum())(jnp.ones((64, 64))))
    assert prof.times == ref.times == {} and prof.total_us == ref.total_us == 0.0
    assert prof.report() == ref.report() == "device total: 0 us"


# ------------------------------------------------------------ (g) the Adam depth fit


@pytest.fixture(scope="module")
def port_adam_30():
    from deodr_tpu_torch.examples import optax_fitting

    return optax_fitting.run(max_iter=30, device="cpu")


def test_adam_fit_first_energies_match_jax(port_adam_30):
    from examples.optax_fitting import run

    want = run(max_iter=5)
    np.testing.assert_allclose(port_adam_30[:5], want, rtol=1e-9)


def test_adam_fit_converges(port_adam_30):
    assert port_adam_30[-1] < port_adam_30[0] * 0.85


# ------------------------------------------------------------ (h) batched rendering


def test_batch_matches_jax_vmap():
    from deodr_tpu.ops.render import render_scene as jax_render_scene
    from deodr_tpu_torch.examples.triangle_soup_fitting import create_example_scene as port_scene
    from deodr_tpu_torch.ops.render import render_scene_batch
    from examples.triangle_soup_fitting import create_example_scene as jax_scene

    np.random.seed(11)
    scene_j = jax_scene(n_tri=5, width=48, height=48, textured_ratio=0.0)
    np.random.seed(11)
    scene_p = port_scene(n_tri=5, width=48, height=48, textured_ratio=0.0, device="cpu")
    base_j = dataclasses.replace(scene_j._buffers(*scene_j._diff_inputs()), texture=None)
    base_p = dataclasses.replace(scene_p._buffers(*(t.detach() for t in scene_p._diff_inputs())), texture=None)

    batch = 4
    rng = np.random.RandomState(0)
    ij_batch = np.asarray(base_j.ij)[None] + rng.randn(batch, *base_j.ij.shape) * 2.0
    assert np.array_equal(base_p.ij.numpy(), np.asarray(base_j.ij))

    def render_one(ij):
        img, _, _ = jax_render_scene(dataclasses.replace(base_j, ij=ij), 1.0)
        return img

    want = np.asarray(jax.jit(jax.vmap(render_one))(jnp.asarray(ij_batch)))
    g_want = np.asarray(jax.jit(jax.grad(lambda b: jnp.sum(jax.vmap(render_one)(b) ** 2)))(jnp.asarray(ij_batch)))

    ij = torch.from_numpy(ij_batch).requires_grad_(True)
    images, z, err = render_scene_batch(dataclasses.replace(base_p, ij=ij), 1.0)
    (images ** 2).sum().backward()
    assert images.shape == (batch, 48, 48, 3) and z.shape == (batch, 48, 48) and err is None
    assert bool(torch.isfinite(images).all()) and bool(torch.isfinite(ij.grad).all())
    assert float((images[0] - images[1]).detach().abs().max()) > 1e-3  # different perturbations → different images
    assert np.abs(images.detach().numpy() - want).max() <= 1e-9
    assert np.abs(ij.grad.numpy() - g_want).max() <= 1e-9 * max(1.0, np.abs(g_want).max())


# ------------------------------------------------------------ (i) the viewer


def make_viewer(tmp_path):
    from deodr_tpu_torch.examples.mesh_viewer import Viewer

    viewer = Viewer(octahedron_mesh(2), width=64, height=48, headless=True, device="cpu")
    viewer.video_path = str(tmp_path / "rec.avi")
    return viewer


def test_viewer_renders_and_toggles(tmp_path):
    viewer = make_viewer(tmp_path)
    frame = viewer.render_frame()
    assert frame.shape == (48, 64, 3) and frame.dtype == np.uint8
    assert (np.abs(frame.astype(int) - frame[0, 0].astype(int)).max(axis=2) > 10).any()

    viewer.process_key(ord("a"))  # antialiasing off
    assert viewer.scene.sigma == 0.0
    assert viewer.render_frame().shape == frame.shape

    viewer.process_key(ord("l"))  # lights off -> pure ambient
    f3 = viewer.render_frame()
    assert f3.shape == frame.shape

    viewer.process_key(ord("r"))  # route cycle kernel -> reference
    assert viewer.impl == "reference"
    np.testing.assert_allclose(viewer.render_frame(), f3, atol=1)  # same picture, other route
    viewer.process_key(ord("r"))
    assert viewer.impl == "brute"
    viewer.process_key(ord("r"))
    assert viewer.impl == "kernel"

    viewer.process_key(ord("q"))
    assert viewer.running is False


def test_viewer_camera_interaction(tmp_path):
    viewer = make_viewer(tmp_path)
    base = viewer.render_frame()
    viewer.interactor.rotate(20, 10)
    rotated = viewer.render_frame()
    assert (base != rotated).any()
    viewer.interactor.zoom(0.5)
    zoomed = viewer.render_frame()
    assert (rotated != zoomed).any()
    r = viewer.interactor.camera().extrinsic[:, :3]
    np.testing.assert_allclose(r.T @ r, np.eye(3), atol=1e-9)


def test_viewer_pan_keeps_orthonormal():
    from deodr_tpu_torch.examples.mesh_viewer import CameraInteractor

    inter = CameraInteractor(np.zeros(3), 1.0, 64, 48)
    inter.rotate(5, -3)
    inter.pan(4, 7)
    r = inter.camera().extrinsic[:, :3]
    np.testing.assert_allclose(r.T @ r, np.eye(3), atol=1e-9)


def test_viewer_pickle_and_video(tmp_path):
    viewer = make_viewer(tmp_path)
    path = viewer.pickle_scene_and_camera(str(tmp_path / "scene.pickle"))
    assert os.path.exists(path)

    pytest.importorskip("cv2")
    viewer.process_key(ord("v"))  # start recording
    viewer.render_frame()
    viewer.render_frame()
    viewer.process_key(ord("v"))  # stop
    assert os.path.exists(viewer.video_path) and os.path.getsize(viewer.video_path) > 0


def test_mesh_plot_helpers(tmp_path):
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from deodr_tpu_torch import ColoredTriMesh

    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    octahedron_mesh(2).plot(ax)
    fig.savefig(tmp_path / "mesh.png")
    plt.close(fig)

    tri = ColoredTriMesh(
        faces=np.array([[0, 1, 2]], dtype=np.int32), vertices=np.array([[0.0, 0, 0], [1, 0, 0], [0, 1, 0]]),
        faces_uv=np.array([[0, 1, 2]], dtype=np.int32), uv=np.array([[0.0, 0], [3, 0], [0, 3]]),
        texture=np.linspace(0, 1, 4 * 4 * 3).reshape(4, 4, 3), compute_adjacencies=False,
    )
    fig, ax = plt.subplots()
    tri.plot_uv_map(ax)
    fig.savefig(tmp_path / "uv.png")
    plt.close(fig)


def test_viewer_frame_matches_jax_viewer(tmp_path):
    from deodr_tpu.geometry.primitives import octahedron_mesh as jax_octahedron
    from examples.mesh_viewer import Viewer as JaxViewer

    port = make_viewer(tmp_path)
    ref = JaxViewer(jax_octahedron(2), width=64, height=48, headless=True)
    for v in (port, ref):
        v.interactor.rotate(12, -7)
        v.interactor.zoom(0.8)
    np.testing.assert_allclose(port.interactor.camera().extrinsic, ref.interactor.camera().extrinsic, atol=1e-12)
    got, want = port.render_frame(), ref.render_frame()
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
