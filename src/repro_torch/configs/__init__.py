"""Architecture registry (port of ``repro.configs``): ``--arch <id>``
resolves here.  Every arch's ``config()`` and ``reduced()`` field for
field, the non-dense families included (they are data only; their models
are later slices, see ``repro_torch.models``)."""
from __future__ import annotations

from . import (arctic_480b, gemma2_27b, gemma_2b, granite_moe_1b,
               internlm2_1_8b, mamba2_130m, phi3_vision_4_2b,
               recurrentgemma_9b, seamless_m4t_large_v2, starcoder2_15b)
from .shapes import SHAPES, ShapeCell, applicable

_MODULES = (mamba2_130m, gemma_2b, starcoder2_15b, internlm2_1_8b,
            gemma2_27b, granite_moe_1b, arctic_480b, phi3_vision_4_2b,
            seamless_m4t_large_v2, recurrentgemma_9b)

ARCHS = {m.ARCH: m for m in _MODULES}
ARCH_IDS = tuple(ARCHS)


def get_config(arch: str, reduced: bool = False):
    try:
        mod = ARCHS[arch]
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(ARCHS)}")
    return mod.reduced() if reduced else mod.config()


__all__ = ["ARCHS", "ARCH_IDS", "SHAPES", "ShapeCell", "applicable",
           "get_config"]
