"""CompresSAE retrieval in PyTorch with hand-written CUDA kernels for Hopper.

The port of the JAX package ``repro``, which stays the reference.  This
package imports neither JAX nor ``repro``; its tests hold it against
``repro`` through numpy arrays.  Importing it builds nothing: each CUDA
kernel is compiled with nvcc at its first launch.
"""
