"""Hand-written Hopper kernels of the port and their wrappers.

``csrc/`` holds the CUDA C++ sources, :mod:`.build` compiles them with
``nvcc`` at first CUDA use, and :mod:`.mttkrp` (spMTTKRP), :mod:`.wkv6`
(RWKV-6) and :mod:`.lru_scan` (RG-LRU) hold the wrappers, their plain
PyTorch versions and the launch counters. Importing this package needs
neither ``nvcc`` nor a card.
"""
