"""Checkpoint / resume for fitting state.

A copy of ``deodr_tpu/checkpoint.py`` (numpy only) for the port's fitters,
whose optimizer state is the same flat set of numpy arrays under the same
names, plus :func:`set_fitter_state`, which hands a fitter such a state
from memory: a port fitter can continue from the state of a JAX package
fitter, saved by either package or read off it directly.
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict

import numpy as np

_FITTER_STATE_KEYS = [
    "vertices",
    "speed_vertices",
    "transform_quaternion",
    "speed_quaternion",
    "transform_translation",
    "speed_translation",
    "mesh_color",
    "speed_mesh_color",
    "light_directional",
    "speed_light_directional",
    "light_ambient",
    "speed_light_ambient",
    "iter",
]


def save_fitter(fitter, path: str) -> None:
    """Atomically save a fitter's optimizer state to an .npz file."""
    state: Dict[str, np.ndarray] = {}
    for key in _FITTER_STATE_KEYS:
        if hasattr(fitter, key):
            state[key] = np.asarray(getattr(fitter, key))
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **state)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def set_fitter_state(fitter, state: dict) -> None:
    """Give ``fitter`` the optimizer state ``state``: numpy arrays (or
    scalars) under the keys of ``_FITTER_STATE_KEYS``, as ``save_fitter``
    writes them or as a fitter of either package holds them. Arrays are
    copied as float64 (``iter`` as an int); a fitter that keeps its state
    elsewhere too (the L-BFGS fitter's parameters) is told to rebuild it.
    Any other key raises ``KeyError``."""
    unknown = sorted(set(state) - set(_FITTER_STATE_KEYS))
    if unknown:
        raise KeyError(f"not fitter state keys: {unknown}")
    for key, value in state.items():
        value = np.array(value)
        if key == "iter":
            value = int(value)
        elif value.ndim == 0:
            value = float(value)
        else:
            value = value.astype(np.float64)
        setattr(fitter, key, value)
    if hasattr(fitter, "state_changed"):
        fitter.state_changed()


def load_fitter(fitter, path: str) -> None:
    """Restore a fitter's optimizer state saved by :func:`save_fitter`."""
    with np.load(path) as data:
        set_fitter_state(fitter, {key: data[key] for key in data.files})
