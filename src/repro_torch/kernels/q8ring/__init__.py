"""Blockwise int8 codec: CUDA kernels (``kernel``), their plain
versions (``ref``) and the ``FusedQ8`` codec (``ops``)."""
