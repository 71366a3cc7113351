"""PyTorch/CUDA port of the RFC-HyPGCN serving stack.

Mirrors the module layout of the JAX package ``repro`` (the reference) so
each counterpart is easy to find, but imports neither ``jax`` nor anything
of ``repro``.  The slice ported so far is 2s-AGCN two-stream clip serving:
configs, skeleton graph, pruning plan, Q8.8 quantization, synthetic clips,
the execution engine's clip mode, and hand-written CUDA kernels for the
fused graph + spatial conv, the cavity temporal conv and RFC
encode/decode (``repro_torch.kernels``).  Entry points run on the GPU
unless the caller passes ``device="cpu"``.
"""
