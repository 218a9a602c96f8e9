"""Shifted natural compression: the CUDA kernel (``kernel``), its plain
version (``ref``) and the any-shape wrapper ``shifted_natural``
(``ops``)."""
