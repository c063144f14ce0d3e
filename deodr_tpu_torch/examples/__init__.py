"""Fitting examples of the port: the hand fitters of the JAX package's
``examples/`` on the port's fitters, with ``device`` and ``dtype``."""
