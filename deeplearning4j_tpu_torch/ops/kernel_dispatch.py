"""Dtype policy, device resolution and resource ceilings for the port's
hand-written CUDA kernels.

Counterpart of `deeplearning4j_tpu/ops/kernel_dispatch.py`, reduced to
what survives the move to Hopper. The dtype policy carries over
unchanged. The JAX package's probe, silent fallback and kill switch do
not: in this package a kernel wrapper given a CPU tensor runs the plain
PyTorch version beside it, and given a CUDA tensor it launches the
kernel or raises. The TPU's VMEM table becomes the shared-memory
ceiling that the card reports for one block.
"""
from __future__ import annotations

import torch


def mxu_dtype(ref_dtype: torch.dtype) -> torch.dtype:
    """The operand type a kernel's products take: bf16 inputs feed the
    tensor cores as bf16, f32 stays f32, f64 (CPU gradient checks)
    stays f64."""
    return torch.bfloat16 if ref_dtype == torch.bfloat16 else ref_dtype


def stat_dtype(dt: torch.dtype) -> torch.dtype:
    """Accumulator and statistic type: f32 for bf16/f32 inputs, f64 for
    f64."""
    return torch.float64 if dt == torch.float64 else torch.float32


def dot_precision(dt: torch.dtype) -> str:
    """Matmul precision for operands of type `dt`, in the terms of
    `torch.set_float32_matmul_precision`: f32 operands multiply in full
    f32 ("highest", no TF32), bf16 operands take the native single-pass
    feed ("medium")."""
    return "medium" if dt == torch.bfloat16 else "highest"


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. CUDA is the default; asking
    for it on a machine without a card raises instead of carrying on
    on the CPU. Pass `device="cpu"` to run the plain PyTorch versions."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: cuda or cpu")
    return dev


def current_slot():
    """The SPMD slot of the calling thread (`parallel.spmd`), or None
    outside a per-slot body: the kernel wrappers tally launches by it."""
    from deeplearning4j_tpu_torch.parallel.spmd import current_slot as slot

    return slot()


def smem_limit_bytes(device) -> int:
    """Shared memory one block may use on `device` after opting in
    above the 48 KB default (227 KB on an H100)."""
    props = torch.cuda.get_device_properties(torch.device(device))
    return int(props.shared_memory_per_block_optin)


# The JAX package's Pallas plumbing: VMEM limits, the TPU compiler
# params, the XLA dot-precision helper and the kernel probes. The card
# has none of these (`smem_limit_bytes` is the shared-memory limit the
# kernels check), and the port has no probe (ROADMAP ground rule 4).
_TPU_ONLY = frozenset({
    "VMEM_LIMIT_BYTES", "dot", "probe_verdict", "run_probe_out_of_trace",
    "tpu_compiler_params", "vmem_limit_bytes", "vmem_limit_for_kind",
})


def __getattr__(name):
    if name in _TPU_ONLY:
        raise NotImplementedError(
            f"ops.kernel_dispatch.{name} is TPU plumbing with no "
            "counterpart in the port (ROADMAP queue C3, closed: not "
            "ported by design; ground rule 4: no probe)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
