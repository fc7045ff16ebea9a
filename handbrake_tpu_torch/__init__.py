"""PyTorch/CUDA port of handbrake_tpu.

A package of its own beside ``handbrake_tpu``: it imports torch, numpy
and ctypes and nothing of the JAX package.  Module paths mirror the JAX
package so each module's counterpart is easy to find.  Entry points run
on the CUDA card unless the caller passes ``device="cpu"``.
"""
