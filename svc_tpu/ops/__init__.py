"""Device compute ops (plain JAX, compiled by XLA).

Batched, jit-compatible replacements for the reference's L2 algorithm layer
(libs/motion.cpp) and for the OpenCV kernels it calls from the pipeline
layer (SURVEY.md §2 rows 22-28): color conversion, Gaussian pyramid,
padding, morphology, k-means, connected components, DCT/IDCT, resize.

Everything here is functional, static-shape, and jit-compatible.
"""
