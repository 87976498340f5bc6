"""Rays, cameras and datasets."""
