"""Helpers that write what the port produces (depth-prior PNGs)."""
