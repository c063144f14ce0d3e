"""Faults planted under a run to show that its comparison catches them.

Each fault is a context manager that breaks the timed path while it is
active: ``unchanged`` (Adam returns the parameters unchanged), ``half_rows``
(the loss over the top half of the rows, doubled: half the batch left out,
the mean taken over the rest) and ``altered`` (the rendered image changed
where the renderer produces it). A fit on one chip has no exchange between
chips to leave out. Used by the tests and by ``calibrate.py``.
"""

from __future__ import annotations

import contextlib

import torch

from perfbench.fit import Fit


@contextlib.contextmanager
def _patched(owner, name, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def unchanged():
    return _patched(torch.optim.Adam, "step", lambda self, closure=None: None)


def half_rows():
    def loss(self, image):
        half = image.shape[0] // 2
        return 2 * ((image[:half] - self.target[:half]) ** 2).sum()

    return _patched(Fit, "loss", loss)


def altered():
    render = Fit.render

    def altered_render(self):
        image = render(self)
        rows = slice(image.shape[0] // 4, image.shape[0] // 4 + max(1, image.shape[0] // 64))
        return torch.cat([image[: rows.start], image[rows] + 0.1, image[rows.stop :]])

    return _patched(Fit, "render", altered_render)


FAULTS = {"unchanged": unchanged, "half_rows": half_rows, "altered": altered}
