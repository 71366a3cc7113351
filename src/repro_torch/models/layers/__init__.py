"""Transformer layer primitives: norms, RoPE, inits (``common``), the gated
MLP (``mlp``) and GQA attention with its KV-cache decode path
(``attention``)."""
