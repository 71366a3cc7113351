"""Paper-mechanism core: the 2s-AGCN model and execution engine
(``agcn``), the hybrid pruning plan C1/C2 (``pruning``) and Q8.8
quantization C5 (``quant``)."""
