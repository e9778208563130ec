"""The xDeepFM CIN layer (``cin``) as a Hopper kernel, its plain
version and the CIN stack over it.

Backends of :func:`cin_layer`:

  * ``"auto"``   -- by device: the Hopper kernel for CUDA tensors, the
    plain version for CPU tensors;
  * ``"plain"``  -- the plain PyTorch version on any device (the CPU
    path, and the comparisons on the card).
"""
from repro_torch.kernels.cin.cin import CIN_BACKENDS, cin_layer
from repro_torch.kernels.cin.ops import cin_forward, cin_forward_reference
from repro_torch.kernels.cin.ref import cin_layer_ref

__all__ = ["CIN_BACKENDS", "cin_forward", "cin_forward_reference",
           "cin_layer", "cin_layer_ref"]
