"""Loss functions (counterpart of `deeplearning4j_tpu/ops/losses.py`).

Pure functions of (labels, pre-activation output), the JAX package's
conventions: per-example score = sum over output dims of the elementwise
loss (MSE: mean); network score = mean over unmasked rows; masks
broadcast over the feature dim. Softmax + MCXENT/NLL and sigmoid + XENT
take the numerically stable log-softmax / logits forms. Sparse integer
class ids (shape preout.shape[:-1]) are taken by MCXENT/NLL + SOFTMAX.
"""
from __future__ import annotations

import enum
import warnings
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops.activations import Activation, activation_fn

_EPS = 1e-8


class LossFunction(str, enum.Enum):
    MSE = "mse"
    L1 = "l1"
    L2 = "l2"
    XENT = "xent"  # binary cross-entropy
    MCXENT = "mcxent"  # multi-class cross-entropy
    NEGATIVELOGLIKELIHOOD = "negativeloglikelihood"
    COSINE_PROXIMITY = "cosine_proximity"
    HINGE = "hinge"
    SQUARED_HINGE = "squared_hinge"
    KL_DIVERGENCE = "kl_divergence"
    MEAN_ABSOLUTE_ERROR = "mean_absolute_error"
    MEAN_ABSOLUTE_PERCENTAGE_ERROR = "mean_absolute_percentage_error"
    MEAN_SQUARED_LOGARITHMIC_ERROR = "mean_squared_logarithmic_error"
    POISSON = "poisson"


def _elementwise_loss(loss: LossFunction, labels, out):
    """Per-element loss on post-activation outputs (the generic path)."""
    if loss in (LossFunction.MSE, LossFunction.L2):
        return (out - labels) ** 2
    if loss in (LossFunction.L1, LossFunction.MEAN_ABSOLUTE_ERROR):
        return torch.abs(out - labels)
    if loss == LossFunction.XENT:
        o = out.clamp(_EPS, 1.0 - _EPS)
        return -(labels * torch.log(o) + (1.0 - labels) * torch.log(1.0 - o))
    if loss in (LossFunction.MCXENT, LossFunction.NEGATIVELOGLIKELIHOOD):
        return -labels * torch.log(out.clamp(min=_EPS))
    if loss == LossFunction.COSINE_PROXIMITY:
        raise ValueError("cosine proximity is row-level")
    if loss == LossFunction.HINGE:
        return torch.clamp(1.0 - labels * out, min=0.0)
    if loss == LossFunction.SQUARED_HINGE:
        return torch.clamp(1.0 - labels * out, min=0.0) ** 2
    if loss == LossFunction.KL_DIVERGENCE:
        return labels * (torch.log(labels.clamp(min=_EPS))
                         - torch.log(out.clamp(min=_EPS)))
    if loss == LossFunction.MEAN_ABSOLUTE_PERCENTAGE_ERROR:
        return 100.0 * torch.abs((labels - out)
                                 / torch.abs(labels).clamp(min=_EPS))
    if loss == LossFunction.MEAN_SQUARED_LOGARITHMIC_ERROR:
        return (torch.log1p(out.clamp(min=-1 + _EPS))
                - torch.log1p(labels.clamp(min=-1 + _EPS))) ** 2
    if loss == LossFunction.POISSON:
        return out - labels * torch.log(out.clamp(min=_EPS))
    raise ValueError(f"unknown loss {loss}")


def loss_per_row(loss, activation, labels, preout):
    """Per-row loss from PRE-activation outputs, shape preout.shape[:-1]."""
    loss = LossFunction(loss)
    activation = Activation(activation)
    if labels.ndim == preout.ndim - 1 and not labels.is_floating_point():
        if loss in (LossFunction.MCXENT, LossFunction.NEGATIVELOGLIKELIHOOD) \
                and activation == Activation.SOFTMAX:
            ls = F.log_softmax(preout, dim=-1)
            # clamp into range: sentinel ids on masked positions must stay
            # harmless
            idx = labels.long().clamp(0, preout.shape[-1] - 1)
            return -torch.gather(ls, -1, idx[..., None])[..., 0]
        raise ValueError(
            "integer class-id labels require MCXENT/NEGATIVELOGLIKELIHOOD "
            f"with SOFTMAX output (got loss={loss.value}, "
            f"activation={activation.value}); pass one-hot labels instead")
    if loss in (LossFunction.MCXENT, LossFunction.NEGATIVELOGLIKELIHOOD) \
            and activation == Activation.SOFTMAX:
        per_elem = -labels * F.log_softmax(preout, dim=-1)
    elif loss == LossFunction.XENT and activation == Activation.SIGMOID:
        per_elem = torch.clamp(preout, min=0.0) - preout * labels \
            + torch.log1p(torch.exp(-torch.abs(preout)))
    elif loss == LossFunction.COSINE_PROXIMITY:
        out = activation_fn(activation)(preout)
        num = (labels * out).sum(dim=-1)
        den = torch.linalg.norm(labels, dim=-1) * torch.linalg.norm(out, dim=-1)
        return -num / den.clamp(min=_EPS)
    else:
        per_elem = _elementwise_loss(loss, labels,
                                     activation_fn(activation)(preout))
    if loss == LossFunction.MSE:
        return per_elem.mean(dim=-1)
    return per_elem.sum(dim=-1)


def loss_score(loss, activation, labels, preout,
               mask: Optional[torch.Tensor] = None):
    """Mean-per-row loss from PRE-activation outputs (a scalar): sum over
    output dims, mean over unmasked rows."""
    return _masked_row_mean(loss_per_row(loss, activation, labels, preout),
                            mask)


def _masked_row_mean(per_row, mask: Optional[torch.Tensor]):
    """Mean over rows; with a mask, masked rows contribute 0 and the
    divisor is the unmasked count (at least 1)."""
    if mask is None:
        return per_row.mean()
    mask = mask.reshape(per_row.shape).to(per_row.dtype)
    return (per_row * mask).sum() / mask.sum().clamp(min=1.0)


def loss_fn(loss):
    """(labels, post-activation output, mask) -> scalar: the generic,
    unfused path evaluation code uses (training scores pre-activations
    with `loss_score`, which is more stable). Sum over output dims (MSE:
    mean), mean over unmasked rows."""
    loss = LossFunction(loss)

    def f(labels, out, mask=None):
        if loss == LossFunction.COSINE_PROXIMITY:
            num = (labels * out).sum(dim=-1)
            den = torch.linalg.norm(labels, dim=-1) \
                * torch.linalg.norm(out, dim=-1)
            return _masked_row_mean(-num / den.clamp(min=_EPS), mask)
        per_elem = _elementwise_loss(loss, labels, out)
        per_row = per_elem.mean(dim=-1) if loss == LossFunction.MSE \
            else per_elem.sum(dim=-1)
        return _masked_row_mean(per_row, mask)

    return f


_range_skip_warned: set = set()


def warn_range_skip_once(key, message: str) -> None:
    """Warn once per `key` that a batch on the device skipped its id or
    label range check."""
    if key in _range_skip_warned:
        return
    _range_skip_warned.add(key)
    warnings.warn(message, stacklevel=3)


def check_sparse_label_range(labels, n_classes, mask=None,
                             where: str = "the output layer",
                             value_range=None) -> None:
    """Raise when a sparse class id falls outside [0, n_classes) — inside
    the loss an out-of-range id would clamp and silently train the wrong
    class. Positions where `mask` == 0 are exempt (pad-with-sentinel plus
    a labels mask). Labels already on the card are not read back: they
    are checked against `value_range`, the (min, max) taken on the host
    when they were staged (`DeviceCacheDataSetIterator`), and without one
    the skipped check is said once."""
    if isinstance(labels, torch.Tensor):
        if labels.is_floating_point():
            return
        if labels.device.type != "cpu":
            if value_range is not None and n_classes:
                mn, mx = value_range
                if mx >= n_classes or mn < 0:
                    bad = mx if mx >= n_classes else mn
                    raise ValueError(
                        f"sparse label id {bad} out of range [0, "
                        f"{n_classes}) for {where} (range recorded when the "
                        "batch was staged on the device)")
            elif n_classes:
                warn_range_skip_once(
                    "labels on the card",
                    "sparse-label range check skipped: labels are on the "
                    "card (pass host arrays to keep the check); "
                    "out-of-range ids will clamp silently")
            return
        labels = labels.numpy()
        if isinstance(mask, torch.Tensor):
            mask = mask.cpu().numpy()
    larr = np.asarray(labels)
    if (not np.issubdtype(larr.dtype, np.integer) or not larr.size
            or not n_classes):
        return
    if mask is not None:
        larr = larr[np.asarray(mask).astype(bool).reshape(larr.shape)]
        if not larr.size:
            return
    mx, mn = int(larr.max()), int(larr.min())
    if mx >= n_classes or mn < 0:
        bad = mx if mx >= n_classes else mn
        raise ValueError(
            f"sparse label id {bad} out of range [0, {n_classes}) for "
            f"{where} (mask padded positions with a labels mask instead of "
            "unmasked sentinel ids)")
