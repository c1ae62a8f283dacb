"""Morph synthesis: quadratic paths, path inversion, rendering, blending."""
