"""Solvers: the lane-major fleet solver and its result type."""
