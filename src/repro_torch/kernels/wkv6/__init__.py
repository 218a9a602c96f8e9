"""RWKV-6 WKV recurrence: CUDA kernels, forward and backward
(``kernel``), their plain versions (``ref``) and the model-layout
``wkv6`` with its gradient (``ops``)."""
