"""PyTorch / CUDA port of the IGGT scene pipeline for NVIDIA Hopper.

Layout and names mirror `iggt_official_tpu` module for module; the JAX
package is the numerical reference.  Every TPU kernel on the ported path has
a hand-written CUDA counterpart under `csrc/` plus a plain PyTorch version
that CPU tensors take.  The kernels serve inference; training
(`train/`) runs through plain PyTorch under autograd, as the JAX package
trains through XLA, and the kernel wrappers refuse inputs that require grad.
"""
