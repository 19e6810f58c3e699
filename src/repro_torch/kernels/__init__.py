"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

``ops`` is the dispatch layer the solver calls: a CPU tensor goes to the
plain version (``ref``), a CUDA tensor to the kernel (``taa_update``,
``flash_attention``, ``flash_decode``, ``ssd_scan``, ``rglru_scan``; each
built from ``csrc/<name>.cu`` by ``build``).
"""
