"""2s-AGCN: skeleton graph, execution engine (clip mode) and model API."""
