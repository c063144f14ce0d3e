"""Mesh fitting by analysis-by-synthesis (depth / RGB / multi-view).

PyTorch counterpart of ``deodr_tpu/mesh_fitter.py``: the same fitters with
the same heavy-ball update rule, step factors and clamps, quaternion
renormalisation and plan logic. A step builds its buffers through the
``Scene3D`` that holds the mesh, renders them through
:func:`deodr_tpu_torch.render_scene` with the fitters' own plan on the
fitter's device (on ``cuda`` with ``impl="kernel"`` the tiled route's
kernels B1 and B2; the plan's edge-cost constants are ``Scene3D``'s, the
JAX planner's), takes the
energy's gradients with ``torch.autograd.grad``, evaluates the rigid
energy beside it, and reads the step's results and the plan statistics
back to the host in one transfer; the update runs in numpy on the host, as
in the JAX package. ``MeshDepthFitterEnergy`` is the total energy as an
``nn.Module`` driven by ``torch.optim.LBFGS``.

Every fitter takes ``device`` (default ``cuda``; asking for CUDA where
there is none raises) and ``dtype`` (default float64), the precision of
the render; the optimizer state stays float64 numpy on the host.
"""

from __future__ import annotations

import copy
import warnings
from typing import Callable, List, Optional, Tuple

import numpy as np
import scipy.spatial.transform
import torch

from deodr_tpu_torch.camera import Camera
from deodr_tpu_torch.geometry.energy import LaplacianRigidEnergy
from deodr_tpu_torch.geometry.mesh import ColoredTriMesh
from deodr_tpu_torch.geometry.transforms import normalize, qrot
from deodr_tpu_torch.ops.render import CAPACITY_CLASSES, SceneBuffers, render_scene, validate_capacities
from deodr_tpu_torch.ops.tiled import TilingConfig, _edge_band_tile_mask, _grid, _occupancy_counts
from deodr_tpu_torch.scene import _C_PX, _F_VISIT, _SUPER_TX, _SUPER_TY, _TILE_W, Scene3D, _bucket

# the tile heights the plan statistics measure (occupancy and edge bands at each)
_TILE_H_CANDIDATES = (8, 16, 32, 48, 64)
_BIG = 1 << 30


def mult_and_clamp(x, a, t):
    return np.minimum(np.maximum(x * a, -t), t)


def _next_pow2_bucket(count: int, lo: int = 8) -> int:
    return int(2 ** np.ceil(np.log2(max(count, lo))))


def _heavy_ball(speed, step, inertia, damping):
    return (1 - damping) * (speed * inertia + (1 - inertia) * step)


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``x`` clipped to [lo, hi] with ``jnp.clip``'s gradient: half of it
    at a tie with a bound (``torch.maximum`` / ``torch.minimum`` split a
    tie's gradient, where ``torch.clamp`` passes all of it)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _fetch(tensors, stats: Optional[torch.Tensor] = None):
    """``tensors`` (and ``stats``) read back to the host in ONE transfer:
    one ``torch.cat`` of the flattened values in float64 (exact for
    float32 ones) and one ``.cpu()`` → list of numpy arrays (floats for
    0-d tensors)[, stats as numpy]."""
    parts = [t.detach().reshape(-1).to(torch.float64) for t in tensors]
    if stats is not None:
        parts.append(stats.detach().to(torch.float64))
    flat = torch.cat(parts).cpu().numpy()
    out, pos = [], 0
    for t in tensors:
        n = t.numel()
        chunk = flat[pos:pos + n]
        out.append(float(chunk[0]) if t.ndim == 0 else chunk.reshape(tuple(t.shape)))
        pos += n
    if stats is None:
        return out
    return flat[pos:], out


def _exchange_frames(group, images, diffs, e_frames, gq, gt, shared_grads):
    """A view-sharded step's collectives: one all-reduce of the frame-summed
    shared gradients, one all-gather of each frame's energy, pose
    gradients, image and residual image → the same values for every frame
    on every rank, the shared gradients summed over all frames."""
    from deodr_tpu_torch.parallel.sharding import _all_gather, _all_reduce_flat

    n = len(images)
    per_frame = [e_frames[:, None], gq, gt, torch.stack(images).reshape(n, -1), torch.stack(diffs).reshape(n, -1)]
    widths = [t.shape[1] for t in per_frame]
    gathered = _all_gather(torch.cat(per_frame, dim=1), group).split(widths, dim=1)
    e_frames, gq, gt = gathered[0][:, 0], gathered[1], gathered[2]
    images = list(gathered[3].reshape((-1,) + tuple(images[0].shape)).unbind(0))
    diffs = list(gathered[4].reshape((-1,) + tuple(diffs[0].shape)).unbind(0))
    return images, diffs, e_frames, gq, gt, _all_reduce_flat(shared_grads, group)


class _FitterRenderCore:
    """The fitters' planner: render plans from plan statistics, kept under
    hysteresis, one host read per step, and a periodic check of every bin
    count.

    The plan is the JAX package's kernel plan (``for_pallas``): 128-wide
    tiles, tile heights 8/16/48 by the median triangle height, the edge
    tile height by the visit-cost model, capacities from the measured
    occupancies with a margin of 1.5 rounded up to powers of two. Where the
    JAX core keeps jitted functions per plan, there is nothing to compile
    here: ``plans`` maps a camera's key to its last accepted plan.
    """

    def __init__(self, mesh: ColoredTriMesh, sigma: float = 1.0):
        self.mesh = mesh
        self.sigma = float(sigma)
        self.plans: dict = {}
        # every check_every planned steps, every bin count of the step's
        # render is checked against the plan's capacities (the plan
        # statistics bound the triangle and edge bins they model; this
        # catches a capacity class they cannot see); 0 turns it off
        self.check_every: int = 25
        self._n_planned_steps: int = 0
        # runs of a step function, re-runs after a replan included
        self.n_runs: int = 0

    def _plan_ctx(self, camera: Camera):
        """(want_tiling, the key the camera's plan is kept under)."""
        want_tiling = self.mesh.nb_faces > 256
        key = (
            camera.extrinsic.tobytes(), camera.intrinsic.tobytes(),
            b"" if camera.distortion is None else np.asarray(camera.distortion).tobytes(),
            camera.height, camera.width, want_tiling,
        )
        return want_tiling, key

    def plan(self, camera: Camera, vertices: torch.Tensor):
        """Plan for one transformed geometry (V, 3) → (aa edge capacity,
        tiling); one host read."""
        return self._plan_impl(camera, vertices[None])

    def plan_multi(self, camera: Camera, vertices_stack: torch.Tensor):
        """One plan covering a stack of per-frame geometries (F, V, 3): the
        statistics are maxed over the frames."""
        return self._plan_impl(camera, vertices_stack)

    def _plan_impl(self, camera, verts_batch):
        return self.plan_from_stats(camera, self.stats(camera, verts_batch).cpu().numpy())

    def plan_guess(self, camera: Camera):
        """The last accepted plan for this camera (None before the first)."""
        return self.plans.get(self._plan_ctx(camera)[1])

    def plan_fits(self, camera: Camera, stats, cap, tiling) -> bool:
        """Was (cap, tiling) enough for geometry with these statistics: no
        silhouette edge dropped, no bin overflowed?"""
        want_tiling, _ = self._plan_ctx(camera)
        cands = _TILE_H_CANDIDATES
        if self.sigma > 0 and (cap is None or int(stats[0]) > cap):
            return False
        if want_tiling:
            if tiling is None:
                return False
            k = cands.index(tiling.tile_h)
            if int(stats[2 + 2 * k]) > tiling.triangle_capacity:
                return False
            ek = cands.index(tiling.edge_tile_h) if tiling.edge_tile_h else k
            if self.sigma > 0 and int(stats[3 + 2 * ek]) > tiling.edge_capacity:
                return False
        return True

    def stats(self, camera: Camera, verts_batch: torch.Tensor) -> torch.Tensor:
        """The plan statistics of a (F, V, 3) stack of geometries, maxed
        over the frames, on the device (no host read): [silhouette edges,
        median triangle height, then for each candidate tile height the
        largest triangle occupancy and edge-band occupancy of a tile, then
        the edge-band tile visits at each candidate], float32, the layout of
        the JAX package's statistics vector."""
        with torch.no_grad():
            return torch.stack([self._frame_stats(camera, v) for v in verts_batch]).amax(dim=0)

    def _frame_stats(self, camera: Camera, vertices: torch.Tensor) -> torch.Tensor:
        mesh, sigma = self.mesh, self.sigma
        height, width = camera.height, camera.width
        want_tiling, _ = self._plan_ctx(camera)
        pts, _ = camera.project_points(vertices)
        dev = pts.device
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        stats = []
        flat = None
        if sigma > 0:
            flags = mesh.edge_on_silhouette(pts)
            visible = mesh.adjacencies.face_visible(pts)
            flat = (flags & visible[:, None]).reshape(-1)
            stats.append(flat.sum())
        else:
            stats.append(zero)
        if want_tiling:
            faces = mesh.adjacencies._index("faces", dev)
            tri = pts[faces]
            x_lo = torch.floor(tri[:, :, 0].amin(dim=1)).clamp(0, width - 1)
            x_hi = torch.floor(tri[:, :, 0].amax(dim=1)).clamp(0, width - 1)
            y_lo = torch.floor(tri[:, :, 1].amin(dim=1)).clamp(0, height - 1)
            y_hi = torch.floor(tri[:, :, 1].amax(dim=1)).clamp(0, height - 1)
            stats.append(torch.quantile(tri[:, :, 1].amax(dim=1) - tri[:, :, 1].amin(dim=1), 0.5))
            if sigma > 0:
                i0 = faces[:, [1, 2, 0]].reshape(-1)
                i1 = faces[:, [0, 1, 2]].reshape(-1)
                p0 = (pts[i0] * flat[:, None]).float()
                p1 = (pts[i1] * flat[:, None]).float()
            every = torch.ones_like(x_lo, dtype=torch.bool)
            n_tx = -(-width // _TILE_W)
            edge_sums = []
            for th in _TILE_H_CANDIDATES:
                n_ty = -(-height // th)
                stats.append(_occupancy_counts(x_lo, x_hi, y_lo, y_hi, every, n_ty, n_tx, th, _TILE_W).max())
                if sigma > 0:
                    m = _edge_band_tile_mask(p0, p1, sigma, flat, _grid(height, width, th, _TILE_W), height, width)
                    stats.append(m.sum(dim=1).max())
                    edge_sums.append(m.sum())
                else:
                    stats.append(zero)
                    edge_sums.append(zero)
            stats += edge_sums
        return torch.stack([s.to(torch.float32) for s in stats])

    def plan_from_stats(self, camera: Camera, stats):
        """Turn plan statistics (numpy) into (cap, tiling), apply the
        hysteresis, and record the result as the camera's last plan."""
        mesh, sigma = self.mesh, self.sigma
        height, width = camera.height, camera.width
        want_tiling, key = self._plan_ctx(camera)
        cands = _TILE_H_CANDIDATES

        cap = None
        need_count = 0
        if sigma > 0:
            need_count = int(stats[0])
            cap = min(3 * mesh.nb_faces, _next_pow2_bucket(need_count))
        tiling = None
        tri_cap = edge_cap = 0
        if want_tiling:
            med_h = float(stats[1])
            tile_h = 8 if med_h <= 12 else (16 if med_h <= 32 else 48)
            tile_h = min(tile_h, max(8, height))
            k = cands.index(tile_h)
            tri_cap = int(stats[2 + 2 * k])
            # edge tile height by the visit-cost model
            edge_tile_h = 0
            if sigma > 0 and int(stats[0]) > 0:
                def edge_cost(th):
                    s = float(stats[2 + 2 * len(cands) + cands.index(th)])
                    return s * (_F_VISIT + th * _TILE_W * _C_PX)

                best_e = min([th for th in cands if th <= 48 and th <= max(8, height)], key=edge_cost)
                edge_tile_h = 0 if best_e == tile_h else best_e
            ek = cands.index(edge_tile_h) if edge_tile_h else k
            edge_cap = int(stats[3 + 2 * ek]) if sigma > 0 else 8
            # two-level binning guard for large fits: the supertile occupancy
            # is bounded by the sum of its member tiles' occupancies
            super_ty = super_tx = super_capacity = 0
            n_tiles_sel = (-(-height // tile_h)) * (-(-width // _TILE_W))
            if n_tiles_sel * max(mesh.nb_faces, 1) > (1 << 22):
                super_ty, super_tx = _SUPER_TY, _SUPER_TX
                super_capacity = _bucket(min(mesh.nb_faces, max(tri_cap, 1) * super_ty * super_tx))
            tiling = TilingConfig(
                tile_h=tile_h, tile_w=_TILE_W, triangle_capacity=_bucket(tri_cap), edge_capacity=_bucket(edge_cap),
                edge_tile_h=edge_tile_h, super_ty=super_ty, super_tx=super_tx, super_capacity=super_capacity,
            )

        # hysteresis: keep the last plan while it still fits the fresh
        # requirements and is at most 4× too large (bucketed capacities
        # would otherwise flip between neighbouring powers of two)
        last = self.plans.get(key)
        if last is not None:
            last_cap, last_tiling = last
            if cap is not None and last_cap is not None and need_count <= last_cap <= 4 * max(cap, 8):
                cap = last_cap
            if (
                tiling is not None
                and last_tiling is not None
                and (last_tiling.tile_h, last_tiling.tile_w, last_tiling.edge_tile_h)
                == (tiling.tile_h, tiling.tile_w, tiling.edge_tile_h)
                and tri_cap <= last_tiling.triangle_capacity <= 4 * tiling.triangle_capacity
                and edge_cap <= last_tiling.edge_capacity <= 4 * tiling.edge_capacity
                and (
                    (tiling.super_capacity == 0 and last_tiling.super_capacity == 0)
                    or (
                        tiling.super_capacity > 0
                        and (tiling.super_ty, tiling.super_tx) == (last_tiling.super_ty, last_tiling.super_tx)
                        and min(mesh.nb_faces, max(tri_cap, 1) * tiling.super_ty * tiling.super_tx)
                        <= last_tiling.super_capacity
                    )
                )
            ):
                tiling = last_tiling
        self.plans[key] = (cap, tiling)
        return cap, tiling

    def drop_plan(self, camera: Camera) -> None:
        self.plans.pop(self._plan_ctx(camera)[1], None)

    def capacity_overflow(self, buffers_list, cap, tiling) -> Optional[str]:
        """Every bin count of the renders of ``buffers_list`` against the
        plan (``validate_capacities``, one host read a render) → None, or
        the first class that overflows with its count and capacity."""
        caps = [
            cap if cap is not None else _BIG,
            tiling.triangle_capacity if tiling else _BIG,
            tiling.edge_capacity if tiling else _BIG,
            (tiling.super_capacity or _BIG) if tiling else _BIG,
            (tiling.drawn_capacity or _BIG) if tiling else _BIG,
        ]
        for buffers in buffers_list:
            counts, ok = validate_capacities(
                buffers, self.sigma, caps,
                tiling.tile_h if tiling else buffers.height,
                tiling.tile_w if tiling else buffers.width,
                tiling.edge_tile_h if tiling else 0,
                (tiling.super_ty, tiling.super_tx) if tiling else (0, 0),
                raise_on_overflow=False,
            )
            if not ok:
                name = next(k for k, c in zip(CAPACITY_CLASSES, caps) if counts[k] > c)
                return f"{name}: occupancy {counts[name]} exceeds capacity {caps[CAPACITY_CLASSES.index(name)]}"
        return None

    def planned_step(self, camera: Camera, verts_batch, run: Callable, buffers_of: Callable):
        """One fitting step with ONE host read.

        Dispatches the plan statistics of ``verts_batch`` (F, V, 3) and the
        step ``run(cap, tiling) → (out, list of tensors)`` with the last
        accepted plan, then reads the statistics and the step's tensors in
        one transfer. If the guessed plan turns out to under-provision a
        bin, the step is re-run once with a fresh plan, so results are
        always exact. Every ``check_every`` steps each bin count of the
        renders of ``buffers_of()`` (the step's SceneBuffers, one per
        frame) is checked against the plan; on an overflow: warn, drop the
        plan, replan from fresh statistics and re-run.

        Returns (out, the tensors as numpy).
        """
        stats_dev = self.stats(camera, verts_batch)
        guess = self.plan_guess(camera)
        stats = None
        if guess is None:
            stats = stats_dev.cpu().numpy()
            guess = self.plan_from_stats(camera, stats)
            stats_dev = None
        cap, tiling = guess

        def counted_run(cap, tiling):
            self.n_runs += 1
            return run(cap, tiling)

        out, tensors = counted_run(cap, tiling)
        if stats_dev is None:
            fetched = _fetch(tensors)
        else:
            stats, fetched = _fetch(tensors, stats_dev)
            self.plan_from_stats(camera, stats)  # hysteresis update for the next step
            if not self.plan_fits(camera, stats, cap, tiling):
                cap, tiling = self.plan_guess(camera)
                out, tensors = counted_run(cap, tiling)
                fetched = _fetch(tensors)

        self._n_planned_steps += 1
        if self.check_every and self._n_planned_steps % self.check_every == 0:
            with torch.no_grad():
                overflow = self.capacity_overflow(buffers_of(), cap, tiling)
            if overflow is not None:
                warnings.warn(f"fitter plan capacity overflowed ({overflow}); replanning")
                self.drop_plan(camera)
                if stats is None:
                    stats = self.stats(camera, verts_batch).cpu().numpy()
                cap, tiling = self.plan_from_stats(camera, stats)
                out, tensors = counted_run(cap, tiling)
                fetched = _fetch(tensors)
        return out, fetched


class _Fitter:
    """What the fitters share: the mesh and the ``Scene3D`` that holds it
    (which checks the device and builds each render's ``SceneBuffers``),
    the rigid energy, the planner, the initial pose and the heavy-ball
    updates, in numpy on the host."""

    def _set_mesh(self, vertices: np.ndarray, faces, cregu: float, device, dtype: torch.dtype, impl: str,
                  **mesh_kwargs) -> None:
        # the mesh's vertex dtype is the render's (Scene3D reads it); the optimizer state stays float64 numpy
        self.mesh = ColoredTriMesh(np.asarray(faces), vertices=torch.from_numpy(vertices).to(dtype), **mesh_kwargs)
        self.scene = Scene3D(sigma=1.0, device=device, impl=impl)
        self.scene.set_mesh(self.mesh)
        self.device, self.dtype, self.impl = self.scene.device, dtype, impl
        self.rigid_energy = LaplacianRigidEnergy(self.mesh, vertices, cregu)
        self.vertices_init = copy.copy(vertices)
        self.core = _FitterRenderCore(self.mesh, sigma=1.0)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=self.dtype, device=self.device)

    def set_mesh_transform_init(self, euler, translation) -> None:
        self.transform_quaternion_init = scipy.spatial.transform.Rotation.from_euler("zyx", euler).as_quat()
        self.transform_translation_init = np.asarray(translation, dtype=np.float64)

    def _set_camera(self, width: int, height: int, focal, distortion) -> None:
        """The fitters' camera: looking down −z from ``camera_center``, the
        principal point at the image centre, ``focal`` 2 × width by default."""
        self.width, self.height = width, height
        focal = 2 * width if focal is None else focal
        rot = np.array([[1.0, 0, 0], [0, -1, 0], [0, 0, -1]])
        trans = -rot.T.dot(self.camera_center)
        intrinsic = np.array([[focal, 0, width / 2], [0, focal, height / 2], [0, 0, 1]])
        self.camera = Camera(extrinsic=np.column_stack((rot, trans)), intrinsic=intrinsic, distortion=distortion,
                             width=width, height=height)
        self._obs = None
        self.iter = 0

    def _update_pose(self, grad, quaternion_b, translation_b) -> None:
        """Heavy-ball steps of the vertices (along −``grad``), the
        quaternion (renormalised) and the translation."""
        inertia, damping = self.inertia, self.damping
        step_vertices = mult_and_clamp(-grad, self.step_factor_vertices, self.step_max_vertices)
        self.speed_vertices = _heavy_ball(self.speed_vertices, step_vertices, inertia, damping)
        self.vertices = self.vertices + self.speed_vertices
        step_quaternion = mult_and_clamp(-quaternion_b, self.step_factor_quaternion, self.step_max_quaternion)
        self.speed_quaternion = _heavy_ball(self.speed_quaternion, step_quaternion, inertia, damping)
        self.transform_quaternion = self.transform_quaternion + self.speed_quaternion
        self.transform_quaternion = self.transform_quaternion / np.linalg.norm(self.transform_quaternion)
        step_translation = mult_and_clamp(-translation_b, self.step_factor_translation, self.step_max_translation)
        self.speed_translation = _heavy_ball(self.speed_translation, step_translation, inertia, damping)
        self.transform_translation = self.transform_translation + self.speed_translation

    def _update_lights_and_color(self, light_directional_b, light_ambient_b, mesh_color_b) -> None:
        inertia, damping = self.inertia, self.damping
        self.speed_light_directional = _heavy_ball(self.speed_light_directional, -light_directional_b * 0.0001,
                                                   inertia, damping)
        self.light_directional = self.light_directional + self.speed_light_directional
        self.speed_light_ambient = _heavy_ball(self.speed_light_ambient, -light_ambient_b * 0.0001, inertia, damping)
        self.light_ambient = self.light_ambient + self.speed_light_ambient
        self.speed_mesh_color = _heavy_ball(self.speed_mesh_color, -mesh_color_b * 0.00001, inertia, damping)
        self.mesh_color = self.mesh_color + self.speed_mesh_color


class MeshDepthFitter(_Fitter):
    """Fit a deformable mesh to a depth image."""

    def __init__(
        self,
        vertices,
        faces,
        euler_init,
        translation_init,
        cregu: float = 2000,
        inertia: float = 0.96,
        damping: float = 0.05,
        device=None,
        dtype: torch.dtype = torch.float64,
        impl: str = "kernel",
    ):
        self.cregu = cregu
        self.inertia = inertia
        self.damping = damping
        self.step_factor_vertices = 0.0005
        self.step_max_vertices = 1
        self.step_factor_quaternion = 0.00006
        self.step_max_quaternion = 0.1
        self.step_factor_translation = 0.00005
        self.step_max_translation = 0.1

        vertices = np.asarray(vertices, dtype=np.float64)
        self._set_mesh(vertices, faces, cregu, device, dtype, impl, colors=np.zeros((vertices.shape[0], 0)))
        object_center = vertices.mean(axis=0)
        object_radius = np.max(np.std(vertices, axis=0))
        self.camera_center = object_center + np.array([-0.5, 0, 5]) * object_radius
        self.set_mesh_transform_init(euler=euler_init, translation=translation_init)
        self.reset()

    def reset(self) -> None:
        self.vertices = copy.copy(self.vertices_init)
        self.speed_vertices = np.zeros(self.vertices_init.shape)
        self.transform_quaternion = copy.copy(self.transform_quaternion_init)
        self.transform_translation = copy.copy(self.transform_translation_init)
        self.speed_translation = np.zeros(3)
        self.speed_quaternion = np.zeros(4)

    def set_max_depth(self, max_depth: float) -> None:
        self.max_depth = max_depth
        self.background_color = np.array([max_depth], dtype=np.float64)
        self.scene.set_background_color(self.background_color)

    def set_depth_scale(self, depth_scale: float) -> None:
        self.depth_scale = depth_scale

    def set_image(self, mesh_image, focal: Optional[float] = None, distortion=None) -> None:
        assert mesh_image.ndim == 2
        self.mesh_image = np.asarray(mesh_image, dtype=np.float64)
        self._set_camera(mesh_image.shape[1], mesh_image.shape[0], focal, distortion)

    def _transformed_vertices(self) -> torch.Tensor:
        q_n = normalize(self._tensor(self.transform_quaternion))
        return qrot(q_n, self._tensor(self.vertices)) + self._tensor(self.transform_translation)

    def _buffers(self, vertices, quaternion, translation) -> SceneBuffers:
        """The render's buffers: one channel, depth × depth_scale."""
        vt = qrot(normalize(quaternion), vertices) + translation
        return self.scene._build_buffers(self.camera, vt, None, None, 0.0, None, None, True,
                                         depth_only_scale=float(self.depth_scale))[0]

    def _data_energy(self, vertices, quaternion, translation, cap, tiling):
        """(data energy, clipped depth image (H, W, 1), squared residual
        image (H, W)) of one render with the plan (cap, tiling)."""
        if self._obs is None:
            self._obs = self._tensor(self.mesh_image)
        buffers = self._buffers(vertices, quaternion, translation)
        image, _, _ = render_scene(buffers, self.core.sigma, aa_edge_capacity=cap, tiling=tiling, impl=self.impl)
        depth_clipped = clip(image, 0.0, self.max_depth)
        diff_image = ((depth_clipped - self._obs[:, :, None]) ** 2).sum(dim=2)
        return diff_image.sum(), depth_clipped, diff_image

    def step(self) -> Tuple[float, torch.Tensor, torch.Tensor]:
        self.vertices = self.vertices - np.mean(self.vertices, axis=0)[None, :]
        params = [self._tensor(self.vertices), self._tensor(self.transform_quaternion),
                  self._tensor(self.transform_translation)]
        with torch.no_grad():
            vt = self._transformed_vertices()

        def run(cap, tiling):
            leaves = [p.detach().requires_grad_(True) for p in params]
            energy, depth, diff_image = self._data_energy(*leaves, cap, tiling)
            grads = torch.autograd.grad(energy, leaves)
            with torch.no_grad():
                e_rigid, grad_rigidity, _ = self.rigid_energy.evaluate(params[0])
            return (depth.detach(), diff_image.detach()), [energy, *grads, e_rigid, grad_rigidity]

        def buffers_of():
            return [self._buffers(*params)]

        (depth, diff_image), fetched = self.core.planned_step(self.camera, vt[None], run, buffers_of)
        energy_data, vertices_b, quaternion_b, translation_b, e_rigid, grad_rigidity = fetched

        vertices_b = vertices_b - np.mean(vertices_b, axis=0)[None, :]
        energy = energy_data + e_rigid
        print("Energy=%f : EData=%f E_rigid=%f" % (energy, energy_data, e_rigid))
        self._update_pose(vertices_b + grad_rigidity, quaternion_b, translation_b)
        self.iter += 1
        return energy, depth[:, :, 0], diff_image


class DepthFitEnergy(torch.nn.Module):
    """The total energy of a depth fit as a module: parameters
    ``vertices``, ``quaternion`` and ``translation``; ``forward()`` is the
    data energy of the centred vertices under the plan in ``self.plan`` plus
    the rigid energy of the vertices."""

    def __init__(self, fitter: "MeshDepthFitterEnergy"):
        super().__init__()
        self._fitter = [fitter]  # a list, so that the module does not own the fitter
        self.vertices = torch.nn.Parameter(fitter._tensor(fitter.vertices))
        self.quaternion = torch.nn.Parameter(fitter._tensor(fitter.transform_quaternion))
        self.translation = torch.nn.Parameter(fitter._tensor(fitter.transform_translation))
        self.plan = None
        self.n_evaluations = 0

    def forward(self) -> torch.Tensor:
        fitter = self._fitter[0]
        cap, tiling = self.plan
        self.n_evaluations += 1
        vertices = self.vertices
        centered = vertices - vertices.mean(dim=0, keepdim=True)
        e_data = fitter._data_energy(centered, self.quaternion, self.translation, cap, tiling)[0]
        e_rigid = fitter.rigid_energy.evaluate(vertices)[0]
        return e_data + e_rigid


class MeshDepthFitterEnergy(MeshDepthFitter):
    """Depth fitting as one energy module (:class:`DepthFitEnergy`)
    optimized with ``torch.optim.LBFGS`` (``history_size=memory_size``,
    strong-Wolfe line search, one iteration a step): the pair the original
    deodr used, where the JAX package runs ``optax.lbfgs``. The plan is
    made once a step, for the line search's evaluations too. The optimizer
    keeps its memory across plan changes."""

    def __init__(self, vertices, faces, euler_init, translation_init, cregu: float = 2000, memory_size: int = 10,
                 device=None, dtype: torch.dtype = torch.float64, impl: str = "kernel"):
        super().__init__(vertices, faces, euler_init, translation_init, cregu=cregu, device=device, dtype=dtype,
                         impl=impl)
        self.memory_size = memory_size

    def reset(self) -> None:
        super().reset()
        self.state_changed()

    def state_changed(self) -> None:
        """Drop the module and the optimizer: the next step builds them
        from the numpy state."""
        self.energy = None
        self._opt = None

    def step(self) -> float:
        with torch.no_grad():
            vt = self._transformed_vertices()
        cap, tiling = self.core.plan(self.camera, vt)
        if self.energy is None:
            self.energy = DepthFitEnergy(self)
            self._opt = torch.optim.LBFGS(self.energy.parameters(), max_iter=1, history_size=self.memory_size,
                                          line_search_fn="strong_wolfe")
        self.energy.plan = (cap, tiling)

        def closure():
            self._opt.zero_grad()
            e = self.energy()
            e.backward()
            return e

        value = self._opt.step(closure)
        # the optimized parameters back onto the numpy state (one host read),
        # so that the plan and external readers see the current geometry
        energy, self.vertices, self.transform_quaternion, self.transform_translation = _fetch(
            [value, self.energy.vertices, self.energy.quaternion, self.energy.translation])
        self.iter += 1
        print("Energy=%f" % energy)
        return energy


class MeshRGBFitterWithPose(_Fitter):
    """Fit a deformable mesh with global color and lights to an RGB image."""

    def __init__(
        self,
        vertices,
        faces,
        euler_init,
        translation_init,
        default_color,
        default_light_directional,
        default_light_ambient,
        cregu: float = 2000,
        inertia: float = 0.96,
        damping: float = 0.05,
        update_lights: bool = True,
        update_color: bool = True,
        device=None,
        dtype: torch.dtype = torch.float64,
        impl: str = "kernel",
    ):
        self.cregu = cregu
        self.inertia = inertia
        self.damping = damping
        self.step_factor_vertices = 0.0005
        self.step_max_vertices = 0.5
        self.step_factor_quaternion = 0.00006
        self.step_max_quaternion = 0.05
        self.step_factor_translation = 0.00005
        self.step_max_translation = 0.1

        vertices = np.asarray(vertices, dtype=np.float64)
        self.default_color = np.asarray(default_color, dtype=np.float64)
        self.default_light_directional = np.asarray(default_light_directional, dtype=np.float64)
        self.default_light_ambient = default_light_ambient
        self.update_lights = update_lights
        self.update_color = update_color
        self._set_mesh(vertices, faces, cregu, device, dtype, impl, nb_colors=3)
        object_center = vertices.mean(axis=0) + np.asarray(translation_init)
        object_radius = np.max(np.std(vertices, axis=0))
        self.camera_center = object_center + np.array([0, 0, 9]) * object_radius
        self.set_mesh_transform_init(euler=euler_init, translation=translation_init)
        self.reset()

    def set_background_color(self, background_color) -> None:
        self.background_color = np.asarray(background_color, dtype=np.float64)
        self.scene.set_background_color(self.background_color)

    def reset(self) -> None:
        self.vertices = copy.copy(self.vertices_init)
        self.speed_vertices = np.zeros(self.vertices.shape)
        self.transform_quaternion = copy.copy(self.transform_quaternion_init)
        self.transform_translation = copy.copy(self.transform_translation_init)
        self.speed_translation = np.zeros(self.transform_translation.shape)
        self.speed_quaternion = np.zeros(self.transform_quaternion.shape)
        self.mesh_color = copy.copy(self.default_color)
        self.light_directional = copy.copy(self.default_light_directional)
        self.light_ambient = self.default_light_ambient
        self.speed_light_directional = np.zeros(self.light_directional.shape)
        self.speed_light_ambient = 0.0
        self.speed_mesh_color = np.zeros(self.mesh_color.shape)

    def set_image(self, mesh_image, focal: Optional[float] = None, distortion=None) -> None:
        assert mesh_image.ndim == 3
        self.mesh_image = np.asarray(mesh_image, dtype=np.float64)
        self._set_camera(mesh_image.shape[1], mesh_image.shape[0], focal, distortion)

    def _buffers(self, vertices, quaternion, translation, mesh_color, light_directional, light_ambient):
        """The render's buffers: the global color times each vertex's
        luminosity (``Scene3D``'s, whose max(0, ·) has JAX's tie rule)."""
        vt = qrot(normalize(quaternion), vertices) + translation
        colors = mesh_color[None, :].expand(self.mesh.nb_vertices, -1)
        return self.scene._build_buffers(self.camera, vt, colors, light_directional, light_ambient, None, None,
                                         True)[0]

    def _data_energy(self, params, obs, cap, tiling, coef: float = 1.0):
        """(data energy, image, squared residual image) of one render."""
        buffers = self._buffers(*params)
        image, _, _ = render_scene(buffers, self.core.sigma, aa_edge_capacity=cap, tiling=tiling, impl=self.impl)
        diff_image = ((image - obs) ** 2).sum(dim=2)
        return coef * diff_image.sum(), image, diff_image

    def _params(self) -> List[torch.Tensor]:
        return [self._tensor(a) for a in (self.vertices, self.transform_quaternion, self.transform_translation,
                                           self.mesh_color, self.light_directional, float(self.light_ambient))]

    def step(self) -> Tuple[float, torch.Tensor, torch.Tensor]:
        self.vertices = self.vertices - np.mean(self.vertices, axis=0)[None, :]
        if self._obs is None:
            self._obs = self._tensor(self.mesh_image)
        params = self._params()
        with torch.no_grad():
            vt = qrot(normalize(params[1]), params[0]) + params[2]

        def run(cap, tiling):
            leaves = [p.detach().requires_grad_(True) for p in params]
            energy, image, diff_image = self._data_energy(leaves, self._obs, cap, tiling)
            grads = torch.autograd.grad(energy, leaves)
            with torch.no_grad():
                e_rigid, grad_rigidity, _ = self.rigid_energy.evaluate(params[0])
            return (image.detach(), diff_image.detach()), [energy, *grads, e_rigid, grad_rigidity]

        def buffers_of():
            return [self._buffers(*params)]

        (image, diff_image), fetched = self.core.planned_step(self.camera, vt[None], run, buffers_of)
        energy_data, vertices_b, quaternion_b, translation_b, mesh_color_b, light_directional_b, light_ambient_b, \
            e_rigid, grad_rigidity = fetched

        energy = energy_data + e_rigid
        print("Energy=%f : EData=%f E_rigid=%f" % (energy, energy_data, e_rigid))
        vertices_b = vertices_b - np.mean(vertices_b, axis=0)[None, :]
        self._update_pose(vertices_b + grad_rigidity, quaternion_b, translation_b)
        self._update_lights_and_color(light_directional_b, light_ambient_b, mesh_color_b)
        self.iter += 1
        return energy, image, diff_image


class MeshRGBFitterWithPoseMultiFrame(MeshRGBFitterWithPose):
    """Fit a deformable mesh to several RGB views with a pose per frame and
    shared vertices, color and lights: the frames render in sequence under
    one plan made from the statistics maxed over the frames, and one host
    read a step; with :meth:`set_device_mesh`, split over the ranks of a
    ``views`` mesh axis.

    As in the JAX package, the data term is each frame's full image
    residual, times ``cdata / nb_frames``.
    """

    def __init__(
        self,
        vertices,
        faces,
        euler_init,
        translation_init,
        default_color,
        default_light_directional,
        default_light_ambient,
        cregu: float = 2000,
        cdata: float = 1,
        inertia: float = 0.97,
        damping: float = 0.15,
        update_lights: bool = True,
        update_color: bool = True,
        device=None,
        dtype: torch.dtype = torch.float64,
        impl: str = "kernel",
    ):
        self.cregu = cregu
        self.cdata = cdata
        self.inertia = inertia
        self.damping = damping
        self.step_factor_vertices = 0.0005
        self.step_max_vertices = 0.5
        self.step_factor_quaternion = 0.00005
        self.step_max_quaternion = 0.05
        self.step_factor_translation = 0.00004
        self.step_max_translation = 0.1

        vertices = np.asarray(vertices, dtype=np.float64)
        self.default_color = np.asarray(default_color, dtype=np.float64)
        self.default_light_directional = np.asarray(default_light_directional, dtype=np.float64)
        self.default_light_ambient = default_light_ambient
        self.update_lights = update_lights
        self.update_color = update_color
        self._set_mesh(vertices, faces, cregu, device, dtype, impl, nb_colors=3)
        object_center = vertices.mean(axis=0)
        self.object_radius = np.max(np.std(vertices, axis=0))
        self.camera_center = object_center + np.array([0, 0, 6]) * self.object_radius
        self.set_mesh_transform_init(euler=euler_init, translation=translation_init)
        self.reset()

    def set_device_mesh(self, device_mesh) -> None:
        """Run the per-frame energies view-parallel over the ``views`` axis
        of a ``torch.distributed`` ``DeviceMesh`` (from
        :func:`deodr_tpu_torch.parallel.make_device_mesh`, or any mesh with
        a dimension named ``views``).

        Every rank holds the same fitter and steps it together. In a step
        each rank computes the energies and gradients of its contiguous
        share of the frames; one all-reduce sums the shared parameters'
        gradients (vertices, color, lights) and one all-gather collects the
        per-frame energies, pose gradients, images and residuals, so every
        rank updates the same parameters; the plan and the host read stay
        the sequential fitter's (every rank plans from the statistics of
        every frame). Requires ``nb_frames`` to be a multiple of the axis'
        size; None returns to the sequential path.
        """
        if device_mesh is not None and "views" not in (getattr(device_mesh, "mesh_dim_names", None) or ()):
            raise ValueError("device mesh must have a 'views' axis")
        self._device_mesh = device_mesh

    def set_images(self, mesh_images: List, focal: Optional[float] = None) -> None:
        assert mesh_images[0].ndim == 3
        self.mesh_images = [np.asarray(im, dtype=np.float64) for im in mesh_images]
        self._set_camera(mesh_images[0].shape[1], mesh_images[0].shape[0], focal, None)

    def energy_data(self, vertices):
        """Data energy of every frame at ``vertices`` → (energy, images,
        residual images); the gradients go to ``_vertices_b``,
        ``transform_quaternion_b``, ``transform_translation_b``,
        ``mesh_color_b``, ``light_directional_b`` and ``light_ambient_b``,
        the rigid energy and its gradient (read in the same host transfer)
        to ``_e_rigid`` and ``_grad_rigidity``."""
        self.vertices = vertices
        nb_frames = self.nb_frames
        if self._obs is None:
            self._obs = [self._tensor(im) for im in self.mesh_images]
        v = self._tensor(self.vertices)
        q_all = self._tensor(self.transform_quaternion)
        t_all = self._tensor(self.transform_translation)
        shared = [self._tensor(a) for a in (self.mesh_color, self.light_directional, float(self.light_ambient))]
        coef_data = self.cdata / nb_frames
        with torch.no_grad():
            vts = qrot(normalize(q_all), v) + t_all[:, None, :]
        frames, group = range(nb_frames), None
        device_mesh = getattr(self, "_device_mesh", None)
        if device_mesh is not None:
            from deodr_tpu_torch.parallel.sharding import _axis

            n_views, coord, group = _axis(device_mesh, "views")
            if nb_frames % n_views:
                raise ValueError(f"nb_frames={nb_frames} must be divisible by the 'views' mesh size {n_views}")
            per = nb_frames // n_views
            frames = range(coord * per, (coord + 1) * per)

        def run(cap, tiling):
            """The energy and gradients of each of this rank's frames: the
            shared parameters' gradients summed over the frames by one
            autograd call (and over the ranks by one all-reduce)."""
            v_l, color_l, ld_l, la_l = (p.detach().requires_grad_(True) for p in [v] + shared)
            q_l = [q_all[i].detach().requires_grad_(True) for i in frames]
            t_l = [t_all[i].detach().requires_grad_(True) for i in frames]
            energies, images, diffs = [], [], []
            for k, i in enumerate(frames):
                e, image, diff = self._data_energy((v_l, q_l[k], t_l[k], color_l, ld_l, la_l), self._obs[i],
                                                   cap, tiling, coef_data)
                energies.append(e)
                images.append(image.detach())
                diffs.append(diff.detach())
            n = len(frames)
            grads = torch.autograd.grad(sum(energies), [v_l, color_l, ld_l, la_l] + q_l + t_l)
            with torch.no_grad():
                e_rigid, grad_rigidity, _ = self.rigid_energy.evaluate(v)
            e_frames, gq, gt = torch.stack(energies).detach(), torch.stack(grads[4:4 + n]), torch.stack(grads[4 + n:])
            shared_grads = list(grads[:4])
            if group is not None:
                images, diffs, e_frames, gq, gt, shared_grads = _exchange_frames(
                    group, images, diffs, e_frames, gq, gt, shared_grads)
            return (images, diffs), [e_frames, gq, gt, *shared_grads, e_rigid, grad_rigidity]

        def buffers_of():
            return [self._buffers(v, q_all[i], t_all[i], *shared) for i in range(nb_frames)]

        (images, diff_images), fetched = self.core.planned_step(self.camera, vts, run, buffers_of)
        e_frames, gq, gt, gv, gc, gld, gla, self._e_rigid, self._grad_rigidity = fetched
        self._vertices_b = gv
        self.transform_quaternion_b = gq
        self.transform_translation_b = gt
        self.mesh_color_b = gc
        self.light_directional_b = gld
        self.light_ambient_b = gla
        return float(np.sum(e_frames)), images, diff_images

    def step(self, check_gradient: bool = False):
        self.vertices = self.vertices - np.mean(self.vertices, axis=0)[None, :]
        self.nb_frames = len(self.mesh_images)
        energy_data, images, diff_images = self.energy_data(self.vertices)
        e_rigid, grad_rigidity = self._e_rigid, self._grad_rigidity
        energy = energy_data + e_rigid
        print(f"iter {self.iter} Energy={energy} : EData={energy_data} E_rigid={e_rigid}")

        if self.iter < 500:
            self._vertices_b = self._vertices_b - np.mean(self._vertices_b, axis=0)[None, :]
        self._update_pose(self._vertices_b + grad_rigidity, self.transform_quaternion_b,
                          self.transform_translation_b)
        self._update_lights_and_color(self.light_directional_b, self.light_ambient_b, self.mesh_color_b)
        self.iter += 1
        return energy, images, diff_images
