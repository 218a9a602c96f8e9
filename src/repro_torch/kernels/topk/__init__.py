"""Block Top-K sparsification: the CUDA kernel (``kernel``), its plain
versions (``ref``: the bisection the kernel computes, and the exact
k-th magnitude) and the any-shape wrapper ``block_topk`` (``ops``)."""
