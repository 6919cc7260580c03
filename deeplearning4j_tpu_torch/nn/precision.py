"""Mixed-precision casting (counterpart of `tree_cast` in
`deeplearning4j_tpu/nn/precision.py`): parameters stay in the master
dtype (f32), compute runs in the compute dtype (bf16)."""
from __future__ import annotations

from typing import Dict

import torch


def tree_cast(params: Dict[str, torch.Tensor],
              dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Cast every tensor of one layer's parameter dict to `dtype`."""
    return {k: v.to(dtype) for k, v in params.items()}
