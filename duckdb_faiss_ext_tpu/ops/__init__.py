"""Compute kernels: pairwise distances, fused search+top-k, k-means, IVF scans.

XLA-first implementations, with a Pallas (Triton) kernel where one beats
XLA on the GPU.
"""
