"""Rotation math and the hand-written CUDA kernels."""
