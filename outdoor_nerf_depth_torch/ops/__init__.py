"""Tensor math of the renderer: numerics, step functions, spaces, compositing."""
