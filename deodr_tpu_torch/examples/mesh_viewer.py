"""Interactive OpenCV mesh viewer, rendered by the port.

Counterpart of ``examples/mesh_viewer.py``: trackball camera interaction,
key toggles for antialiasing / lights / perspective-correct mapping /
renderer route, FPS overlay, video recording, scene pickling, texture-map
display. Every frame is a render of ``deodr_tpu_torch.Scene3D`` on the
viewer's ``device`` (default ``cuda``); the renderer toggle cycles the
port's routes where the JAX viewer cycles ``auto → xla → brute``: the
kernels (``"kernel"``), the tiled route's plain PyTorch versions
(``"reference"``) and the untiled route (``"brute"``). OpenCV is imported
only where a window, a mouse event or a video needs it.

Drivable without a display: ``Viewer(headless=True)`` never opens a
window; tests call ``render_frame()`` / ``process_key()`` / ``interactor``
methods directly (tests/test_torch_port_aux.py).
"""

from __future__ import annotations

import os
import pickle
import time

import numpy as np

from deodr_tpu_torch import ColoredTriMesh, Scene3D, data_path
from deodr_tpu_torch.camera import Camera


class CameraInteractor:
    """Orbit/pan/zoom camera state around an object center.

    The camera extrinsic is re-derived from (yaw, pitch, distance, target)
    each frame, so interaction is stateless with respect to the render.
    """

    modes = ("object_centered_trackball", "first_person")

    def __init__(self, center, object_radius, width, height, fov=60.0):
        self.mode = self.modes[0]
        self.center = np.asarray(center, dtype=np.float64)
        self.object_radius = float(object_radius)
        self.distance = 3.5 * self.object_radius
        self.yaw = 0.0
        self.pitch = 0.0
        self.fov = float(fov)
        self.width = int(width)
        self.height = int(height)
        self._drag = None  # (button, x, y)

    def toggle_mode(self) -> None:
        i = self.modes.index(self.mode)
        self.mode = self.modes[(i + 1) % len(self.modes)]

    # -- direct manipulation (also used headless by tests) -----------------

    def rotate(self, dx_pixels: float, dy_pixels: float) -> None:
        self.yaw += 2.0 * np.pi * dx_pixels / max(self.width, 1)
        self.pitch = np.clip(
            self.pitch + 2.0 * np.pi * dy_pixels / max(self.height, 1),
            -0.49 * np.pi,
            0.49 * np.pi,
        )

    def pan(self, dx_pixels: float, dy_pixels: float) -> None:
        # move the target in the camera's image plane
        r = self._rotation()
        scale = 2.0 * self.distance * np.tan(0.5 * np.deg2rad(self.fov)) / max(self.height, 1)
        self.center = self.center - scale * (dx_pixels * r[0, :] + dy_pixels * r[1, :])

    def zoom(self, factor: float) -> None:
        self.distance = float(np.clip(self.distance * factor, 0.05 * self.object_radius, 100 * self.object_radius))

    def _rotation(self) -> np.ndarray:
        cy, sy = np.cos(self.yaw), np.sin(self.yaw)
        cp, sp = np.cos(self.pitch), np.sin(self.pitch)
        # camera axes in world coordinates (OpenCV convention: x right,
        # y down, z forward), yaw about world Y then pitch about camera X
        yaw_m = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        pitch_m = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        flip = np.array([[1.0, 0, 0], [0, -1, 0], [0, 0, -1]])  # look toward -z of the yaw frame
        return pitch_m @ flip @ yaw_m

    def camera(self) -> Camera:
        r = self._rotation()
        eye = self.center - self.distance * r[2, :]
        t = -r @ eye
        extrinsic = np.column_stack((r, t))
        focal = 0.5 * self.height / np.tan(0.5 * np.deg2rad(self.fov))
        intrinsic = np.array(
            [[focal, 0, 0.5 * self.width], [0, focal, 0.5 * self.height], [0, 0, 1]], dtype=np.float64
        )
        return Camera(extrinsic=extrinsic, intrinsic=intrinsic, width=self.width, height=self.height)

    # -- OpenCV mouse plumbing ----------------------------------------------

    def mouse_callback(self, event, x, y, flags, param) -> None:
        import cv2

        if event in (cv2.EVENT_LBUTTONDOWN, cv2.EVENT_MBUTTONDOWN, cv2.EVENT_RBUTTONDOWN):
            self._drag = (event, x, y)
        elif event in (cv2.EVENT_LBUTTONUP, cv2.EVENT_MBUTTONUP, cv2.EVENT_RBUTTONUP):
            self._drag = None
        elif event == cv2.EVENT_MOUSEMOVE and self._drag is not None:
            button, px, py = self._drag
            dx, dy = x - px, y - py
            self._drag = (button, x, y)
            if button == cv2.EVENT_LBUTTONDOWN:
                self.rotate(dx, dy)
            elif button == cv2.EVENT_RBUTTONDOWN:
                self.zoom(np.exp(0.005 * dy))
            else:
                self.pan(dx, dy)
        elif event == cv2.EVENT_MOUSEWHEEL:
            self.zoom(0.9 if flags > 0 else 1.0 / 0.9)


class Viewer:
    """Interactive viewer over the port's renderer (reference:
    deodr/examples/mesh_viewer.py:200-537, re-designed: pure pull-model
    ``render_frame`` + a key dispatch table; no OpenGL fallback renderer —
    the 'renderer toggle' switches the render route instead)."""

    impls = ("kernel", "reference", "brute")

    def __init__(
        self,
        file_or_mesh=None,
        width: int = 320,
        height: int = 240,
        display_fps: bool = True,
        headless: bool = False,
        title: str = "deodr_tpu_torch viewer",
        device=None,
    ):
        if file_or_mesh is None:
            file_or_mesh = os.path.join(data_path, "duck.obj")
        self.device = device
        self.width = int(width)
        self.height = int(height)
        self.display_fps = display_fps
        self.headless = headless
        self.title = title

        self.use_antialiasing = True
        self.sigma = 1.0
        self.use_lights = True
        self.light_directional = np.array([0.0, -0.4, -0.4])
        self.light_ambient = 0.6
        self.impl = self.impls[0]  # renderer toggle: kernel -> reference -> brute
        self.perspective_correct = False
        self.recording = None  # cv2.VideoWriter when recording
        self.video_path = "viewer_record.avi"
        self.running = False
        self._fps = 0.0
        self._last_frame_time = None
        self._keys = {}

        self.set_mesh(file_or_mesh)
        self.register_keys()

    # -- scene management ----------------------------------------------------

    def set_mesh(self, file_or_mesh) -> None:
        if isinstance(file_or_mesh, str):
            self.mesh = ColoredTriMesh.load(file_or_mesh)
        else:
            self.mesh = file_or_mesh
        self._rebuild_scene()
        v = self.mesh.vertices.detach().cpu().numpy()
        center = 0.5 * (v.max(axis=0) + v.min(axis=0))
        radius = float(np.linalg.norm(v - center, axis=1).max())
        self.interactor = CameraInteractor(center, radius, self.width, self.height)

    def _rebuild_scene(self) -> None:
        self.scene = Scene3D(
            sigma=self.sigma if self.use_antialiasing else 0.0,
            perspective_correct=self.perspective_correct,
            impl=self.impl,
            device=self.device,
        )
        self.scene.set_mesh(self.mesh)
        if self.use_lights:
            self.scene.set_light(light_directional=self.light_directional, light_ambient=self.light_ambient)
        else:
            self.scene.set_light(light_directional=None, light_ambient=1.0)
        self.scene.set_background_color(np.array([0.9, 0.9, 0.9]))

    # -- toggles (each is a registered key) ----------------------------------

    def toggle_antialiasing(self) -> None:
        self.use_antialiasing = not self.use_antialiasing
        self._rebuild_scene()

    def toggle_lights(self) -> None:
        self.use_lights = not self.use_lights
        self._rebuild_scene()

    def toggle_perspective_correct(self) -> None:
        self.perspective_correct = not self.perspective_correct
        self._rebuild_scene()

    def toggle_renderer(self) -> None:
        self.impl = self.impls[(self.impls.index(self.impl) + 1) % len(self.impls)]
        self._rebuild_scene()

    def toggle_interactor_mode(self) -> None:
        self.interactor.toggle_mode()

    def toggle_video_recording(self) -> None:
        if self.recording is None:
            import cv2

            self.recording = cv2.VideoWriter(
                self.video_path, cv2.VideoWriter_fourcc(*"MJPG"), 20.0, (self.width, self.height)
            )
        else:
            self.recording.release()
            self.recording = None

    def pickle_scene_and_camera(self, path: str = "scene.pickle") -> str:
        def host(t):
            return None if t is None else t.detach().cpu().numpy()

        state = {
            "mesh": {
                "faces": np.asarray(self.mesh.faces),
                "vertices": host(self.mesh.vertices),
                "colors": host(self.mesh.vertices_colors),
                "uv": host(self.mesh.uv),
                "faces_uv": self.mesh.faces_uv,
                "texture": host(self.mesh.texture),
            },
            "camera": self.interactor.camera(),
            "sigma": self.scene.sigma,
            "lights": (self.light_directional, self.light_ambient, self.use_lights),
        }
        with open(path, "wb") as f:
            pickle.dump(state, f)
        return path

    def display_texture_map(self) -> None:
        if self.mesh.texture is None:
            print("mesh has no texture")
            return
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        self.mesh.plot_uv_map(ax)
        fig.savefig("texture_map.png")
        plt.close(fig)

    def quit(self) -> None:
        self.running = False

    def register_keys(self) -> None:
        self.register_key("a", self.toggle_antialiasing)
        self.register_key("l", self.toggle_lights)
        self.register_key("p", self.toggle_perspective_correct)
        self.register_key("r", self.toggle_renderer)
        self.register_key("m", self.toggle_interactor_mode)
        self.register_key("v", self.toggle_video_recording)
        self.register_key("s", lambda: self.pickle_scene_and_camera())
        self.register_key("t", self.display_texture_map)
        self.register_key("h", self.print_help)
        self.register_key("q", self.quit)

    def register_key(self, key: str, func) -> None:
        self._keys[ord(key)] = func

    def process_key(self, key: int) -> None:
        if key in self._keys:
            self._keys[key]()

    def print_help(self) -> None:
        print(
            "keys: a=antialiasing  l=lights  p=perspective-correct  r=renderer impl\n"
            "      m=interactor mode  v=record video  s=pickle scene  t=texture map\n"
            "      h=help  q=quit\n"
            "mouse: left-drag rotate, middle-drag pan, right-drag / wheel zoom"
        )

    # -- frame production ------------------------------------------------------

    def render_frame(self) -> np.ndarray:
        """Render the current view; returns an (H, W, 3) uint8 RGB frame."""
        camera = self.interactor.camera()
        image = self.scene.render(camera).cpu().numpy()
        if image.shape[2] == 1:
            image = np.repeat(image, 3, axis=2)
        frame = (np.clip(image, 0, 1) * 255).astype(np.uint8)
        now = time.perf_counter()
        if self._last_frame_time is not None:
            inst = 1.0 / max(now - self._last_frame_time, 1e-6)
            self._fps = 0.9 * self._fps + 0.1 * inst if self._fps else inst
        self._last_frame_time = now
        if self.display_fps and not self.headless:
            self._draw_fps(frame)
        if self.recording is not None:
            self.recording.write(frame[:, :, ::-1])
        return frame

    def _draw_fps(self, frame: np.ndarray) -> None:
        import cv2

        cv2.putText(
            frame, f"fps:{self._fps:5.1f} [{self.impl}]", (5, 16), cv2.FONT_HERSHEY_PLAIN, 1.0, (0, 0, 255), 1
        )

    # -- main loop --------------------------------------------------------------

    def start(self, print_help: bool = True, max_frames: int | None = None) -> None:
        if self.headless:
            raise RuntimeError("start() needs a display; drive render_frame()/process_key() directly")
        import cv2

        if print_help:
            self.print_help()
        cv2.namedWindow(self.title)
        cv2.setMouseCallback(self.title, self.interactor.mouse_callback)
        self.running = True
        n = 0
        while self.running:
            frame = self.render_frame()
            cv2.imshow(self.title, frame[:, :, ::-1])
            key = cv2.waitKey(1)
            if key == 27:
                break
            if key > 0:
                self.process_key(key)
            n += 1
            if max_frames is not None and n >= max_frames:
                break
        if self.recording is not None:
            self.toggle_video_recording()
        cv2.destroyWindow(self.title)


def run() -> None:
    import argparse

    parser = argparse.ArgumentParser(description="Interactive mesh viewer rendered by deodr_tpu_torch")
    parser.add_argument("mesh", nargs="?", default=None, help="path to an .obj mesh (default: duck)")
    parser.add_argument("--width", type=int, default=480)
    parser.add_argument("--height", type=int, default=360)
    parser.add_argument("--device", default=None, help="torch device (default cuda)")
    args = parser.parse_args()
    Viewer(args.mesh, width=args.width, height=args.height, device=args.device).start()


if __name__ == "__main__":
    run()
