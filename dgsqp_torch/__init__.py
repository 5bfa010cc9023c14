"""dgsqp_torch: the DGSQP dynamic-game solver on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``dgsqp_tpu``, module for module, checked against it on the
same inputs.  It imports torch, numpy and scipy, never JAX.  Entry points run on the
card (``device='cuda'``) unless the caller passes ``device='cpu'``.
"""
