"""Hand-written Hopper kernels of the port and their wrappers.

``csrc/`` holds the CUDA C++ sources, :mod:`.build` compiles them with
``nvcc`` at first CUDA use, and :mod:`.mttkrp` (spMTTKRP) and :mod:`.wkv6`
(RWKV-6) hold the wrappers, their plain PyTorch versions and the launch
counters. Importing this package needs neither ``nvcc`` nor a card.
"""
