"""The bench scene as numpy ``SceneBuffers`` fields.

``bench_scene_fields`` builds, from seed 0, the scene that the JAX
package's ``bench.build_scene`` builds: random untextured triangles, all
front-facing, with random depths and vertex colors. Hand it to
:func:`deodr_tpu_torch.scene_buffers_from_numpy`.
"""

import numpy as np


def bench_scene_fields(height=512, width=512, n_tri=200) -> dict:
    """n_tri random untextured triangles of up to 160 px in a
    height × width frame, as the float32 / int32 fields and meta fields of
    ``SceneBuffers``."""
    rng = np.random.RandomState(0)
    centers = rng.rand(n_tri, 1, 2) * [width, height]
    tri = (centers + (rng.rand(n_tri, 3, 2) - 0.5) * 160).astype(np.float32)
    u = tri[:, 1] - tri[:, 0]
    w = tri[:, 2] - tri[:, 0]
    raw = u[:, 0] * w[:, 1] - w[:, 0] * u[:, 1]
    tri[raw > 0] = tri[raw > 0][:, [0, 2, 1]]
    faces = np.arange(3 * n_tri, dtype=np.int32).reshape(n_tri, 3)
    return dict(
        faces=faces,
        faces_uv=faces,
        ij=tri.reshape(-1, 2),
        depths=(np.repeat(rng.rand(n_tri), 3) + 0.5).astype(np.float32),
        uv=np.zeros((3 * n_tri, 2), np.float32),
        shade=np.zeros((3 * n_tri,), np.float32),
        colors=rng.rand(3 * n_tri, 3).astype(np.float32),
        edgeflags=np.ones((n_tri, 3), bool),
        textured=np.zeros((n_tri,), bool),
        shaded=np.zeros((n_tri,), bool),
        texture=None,
        background_image=None,
        background_color=np.array([0.3, 0.5, 0.7], np.float32),
        height=height,
        width=width,
        clockwise=False,
        backface_culling=True,
        strict_edge=True,
        perspective_correct=False,
        integer_pixel_centers=True,
    )
