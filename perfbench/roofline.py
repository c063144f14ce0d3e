"""The yardstick of the kernels' roofline share: the card's peaks and the
least bytes and operations of one fit step's pixel work, counted from the
scene alone.

What any implementation of the step's rasterization has to move, whatever
its tiles, slots or kernels: the forward writes the colour of every pixel
the front faces cover and of every pixel in the σ-bands of the silhouette
edges once, the backward reads the image's cotangent at those pixels once,
both read each vertex's projected position, depth and colour, the
backward writes each vertex's position and colour gradient, and both read
the faces' corner indices (int32). Operations: one affine plane per
channel at each covered pixel, and four band planes, a transparency and a
blend per band pixel, forward and backward. Pixels are the front faces'
screen area and the bands' area (length × σ), clipped to the frame.
"""

from __future__ import annotations

import torch

from perfbench.reference import Scene

# NVIDIA's data sheet for the H100 SXM: HBM3 bandwidth, dense rates without tensor cores, at the 700 W limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "flops_per_s": {"float32": 67e12, "float64": 34e12}},
}


def scene_sizes(scene: Scene, vertices: torch.Tensor, channels: int) -> dict:
    """The sizes the work counts read, from the scene's geometry."""
    with torch.no_grad():
        v = vertices.double()
        ij, depth = scene.project(v)
        front = scene.front(ij, depth)
        tri = ij[scene.faces]
        u, w = tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
        area = 0.5 * (u[:, 0] * w[:, 1] - w[:, 0] * u[:, 1]).abs()
        covered = min(float(area[front].sum()), float(scene.height * scene.width))
        sil = scene.silhouette(front)
        f, k = sil.nonzero(as_tuple=True)
        d = ij[scene.faces[f, (k + 1) % 3]] - ij[scene.faces[f, k]]
        band = float(torch.sqrt((d * d).sum(1)).sum()) * scene.sigma
    return {"covered_pixels": covered, "band_pixels": band, "channels": int(channels),
            "vertices": int(vertices.shape[0]), "faces": int(scene.faces.shape[0])}


def step_work(sizes: dict, itemsize: int) -> dict:
    """Least bytes and operations of one step's rasterization (forward and
    backward) for these sizes."""
    c, px, band = sizes["channels"], sizes["covered_pixels"], sizes["band_pixels"]
    image_bytes = 2 * (px + band) * c * itemsize  # written once forward, its cotangent read once backward
    vertex_bytes = sizes["vertices"] * ((3 + c) + (2 + c)) * itemsize
    face_bytes = 2 * sizes["faces"] * 3 * 4
    flops = 2 * (px * 4 * c + band * (4 * 4 + 4 + 3 * c))
    return {"bytes": image_bytes + vertex_bytes + face_bytes, "flops": flops}


def least_seconds(work: dict, dtype: str, device_kind: str):
    """(least seconds, "bytes" or "flops": which bound sets it), or None
    for a card without a peak in the table."""
    peak = PEAKS.get(device_kind)
    if peak is None:
        return None
    t_bytes = work["bytes"] / peak["bytes_per_s"]
    t_flops = work["flops"] / peak["flops_per_s"][dtype]
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops, "flops")
