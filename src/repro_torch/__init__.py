"""PyTorch port of the paged serving system, with hand-written Hopper kernels.

Mirrors the layout of the JAX package (``configs``, ``core``, ``kernels``,
``serving``, ``launch``) and keeps its module and function names.  The port
imports ``torch`` only: nothing of JAX and nothing of the JAX package.
"""
