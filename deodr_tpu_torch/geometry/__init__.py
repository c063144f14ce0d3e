"""Mesh topology (numpy, static) and per-frame mesh geometry (torch)."""
