"""Hand-written CUDA kernels for the sweeps and the distance tile
(``csrc/``), their plain torch versions (``ref``) and the wrappers the
engine calls (``ops``).

Nothing here builds or imports a compiler at import time: the library is
built with ``nvcc`` on the first launch (``build.library``).
"""
from . import ops, ref
from .gmm_topb import gmm_topb_cuda
from .gmm_update import gmm_update_select_cuda
from .pairwise import pairwise_cuda

__all__ = ["ops", "ref", "gmm_topb_cuda", "gmm_update_select_cuda",
           "pairwise_cuda"]
