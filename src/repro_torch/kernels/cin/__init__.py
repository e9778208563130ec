"""The xDeepFM CIN layer (``cin``) as a Hopper kernel, its gradient as
Hopper kernels, their plain versions and the CIN stack over them.

Backends of :func:`cin_layer`:

  * ``"auto"``   -- by device: the Hopper kernel for CUDA tensors, the
    plain version for CPU tensors; through :class:`CinLayer` when
    autograd records a graph, whose backward runs :func:`cin_grad_x0`,
    :func:`cin_grad_xk` and :func:`cin_grad_w` (kernels on the card,
    the plain formulas on the CPU);
  * ``"plain"``  -- the plain PyTorch version on any device (the CPU
    path, and the comparisons on the card).
"""
from repro_torch.kernels.cin.cin import (CIN_BACKENDS, CinLayer, cin_grad_w,
                                         cin_grad_x0, cin_grad_xk, cin_layer)
from repro_torch.kernels.cin.ops import cin_forward, cin_forward_reference
from repro_torch.kernels.cin.ref import (cin_layer_backward_plain,
                                         cin_layer_ref)

__all__ = ["CIN_BACKENDS", "CinLayer", "cin_forward",
           "cin_forward_reference", "cin_grad_w", "cin_grad_x0",
           "cin_grad_xk", "cin_layer", "cin_layer_backward_plain",
           "cin_layer_ref"]
