"""PyTorch/CUDA port of the RFC-HyPGCN serving stack.

Mirrors the module layout of the JAX package ``repro`` (the reference) so
each counterpart is easy to find, but imports neither ``jax`` nor anything
of ``repro``.  Ported so far: 2s-AGCN two-stream clip serving, per-frame
streaming and the session-slab tick, for every registry skeleton (plans
padded to a shared slab width, dense or CSR spatial conv) and with the
windowed C_k graph: configs, skeleton graphs, pruning plan, Q8.8
quantization, synthetic clips, the execution engine; the serving host
layer and ``GcnService`` (``serving``); KV-cache decode serving of the
dense decoder LM family (``models``: smollm-360m, h2o-danube-1.8b); and
the paper's offline path: 2s-AGCN training (``optim.adamw``,
``train.steps.make_train_step``, ``checkpoint.store``, ``fault.monitor``,
``launch.train``) and the accounting of hybrid pruning, RFC storage and
E(D) scheduling (``core.pruning``, ``core.rfc``, ``core.sched``), with
hand-written CUDA kernels (``repro_torch.kernels``) on the serving paths
and the RFC pair in ``core.rfc.checkpoint``.  Entry points run on the GPU
unless the caller passes ``device="cpu"``.
"""
