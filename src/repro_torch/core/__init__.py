"""Paper-mechanism core: the 2s-AGCN model and execution engine
(``agcn``), the hybrid pruning plan C1/C2 and its accounting
(``pruning``), the RFC format's storage model and checkpointed MLP C3
(``rfc``), the E(D) scheduling model (``sched``) and the Q8.8 and int8
quantization C5 (``quant``)."""
