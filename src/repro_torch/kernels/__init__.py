"""Hand-written Hopper (sm_90a) kernels of the port, one package each.

Each kernel package holds the ctypes-bound CUDA kernel (sources in
``repro_torch/csrc``, built by ``kernels/_build.py``), its plain PyTorch
version, and a wrapper that launches the kernel for CUDA tensors and
takes the plain version only for tensors on the CPU.
"""
