"""Mixed-precision casting (counterpart of
`deeplearning4j_tpu/nn/precision.py`): parameters stay in the master dtype
(f32), the forward and backward run in the compute dtype (bf16), the loss
head and L1/L2 in the master dtype."""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def tree_cast(params: Dict[str, torch.Tensor],
              dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Cast every tensor of one layer's parameter dict to `dtype`."""
    return {k: v.to(dtype) for k, v in params.items()}


def restore_dtypes(tree: List[Dict[str, torch.Tensor]],
                   ref_tree: List[Dict[str, torch.Tensor]]):
    """Cast each tensor back to its counterpart's dtype (carried state
    keeps its precision across steps)."""
    return [{k: v.to(ref[k].dtype) for k, v in d.items()}
            for d, ref in zip(tree, ref_tree)]


def wire_asarray(a, dtype: torch.dtype, device, as_ids: bool = False):
    """Host -> device transfer policy of every fit/score/output path: float
    features go to the model dtype; compact non-float dtypes (uint8
    pixels, int ids) cross as they are. `as_ids`: the array feeds an
    integer-id consumer, so float ids are truncated to int32 rather than
    cast to a narrow float type (bf16 rounds ids above 256)."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(np.asarray(a)))
    if a.is_floating_point():
        a = a.to(torch.int32) if as_ids else a.to(dtype)
    return a.to(device, non_blocking=True)


def __getattr__(name):
    if name == "stack_wire":
        raise NotImplementedError(
            "nn.precision.stack_wire stacks batches for the JAX package's "
            "scanned fit dispatch; the port runs fit(scan_steps=) one step "
            "a batch and needs none (ROADMAP queue C3, closed: not ported "
            "by design)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
