"""Hand-written CUDA kernels for the paper's hot spots, each beside its
plain PyTorch version: the graph + 1×1 spatial conv over a dense and over
an ELL-packed sparse graph (``graph_sconv``), the cavity-pruned temporal
conv (``cavity_tconv``), RFC encode/decode (``rfc_pack``), the
streaming C_k graph (``window_sim``) and the LM decode attention
(``flash_decode``); the layout-adapting wrappers
(``ops``), the plain oracles (``ref``) and the nvcc build (``_build``).

Every kernel wrapper dispatches on the device of its input: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel (or raises).
"""
