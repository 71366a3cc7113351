"""2s-AGCN: skeleton graphs, the windowed C_k (``adaptive``), the
execution engine (clip mode, streaming, the session slab) and model API."""
