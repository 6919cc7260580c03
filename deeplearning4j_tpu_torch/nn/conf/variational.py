"""Variational autoencoder layer and its reconstruction distributions
(counterpart of `deeplearning4j_tpu/nn/conf/variational.py`).

The whole negative ELBO (encoder -> reparameterised sample -> decoder ->
log p(x|z) - KL) is one function of the layer's parameters that autograd
differentiates in `MultiLayerNetwork.pretrain`. Inside a supervised
network `forward` gives the mean of q(z|x), with no sampling. The draws
come from a `torch.Generator` on the input's device (`rng`); with
rng=None every eps is 0, a deterministic route for checks. Fields, JSON
and parameter names are the JAX package's.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    FeedForwardLayer,
    Params,
    register_layer,
)
from deeplearning4j_tpu_torch.ops.activations import Activation, activation_fn
from deeplearning4j_tpu_torch.ops.losses import LossFunction, _elementwise_loss

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)

# ---------------------------------------------------------------------------
# reconstruction distributions

_DIST_REGISTRY: Dict[str, type] = {}


def register_distribution(cls):
    _DIST_REGISTRY[cls.TYPE] = cls
    return cls


@dataclass
class ReconstructionDistribution:
    """p(x|z): maps the decoder's pre-output (the distribution's
    parameters) and the data to a log probability."""

    TYPE = "base"

    def distribution_input_size(self, data_size: int) -> int:
        raise NotImplementedError

    def log_probability(self, x: torch.Tensor, pre: torch.Tensor
                        ) -> torch.Tensor:
        """log p(x | distribution parameters) per example, shape (B,)."""
        raise NotImplementedError

    def sample_mean(self, pre: torch.Tensor) -> torch.Tensor:
        """E[x|z] given the decoder's pre-output."""
        raise NotImplementedError

    def to_json(self) -> dict:
        d = {"type": self.TYPE}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, ReconstructionDistribution):
                v = v.to_json()
            elif isinstance(v, (list, tuple)) and v \
                    and isinstance(v[0], (list, tuple)):
                v = [[p[0], p[1].to_json()] for p in v]
            elif hasattr(v, "value"):
                v = v.value
            d[f.name] = v
        return d

    @staticmethod
    def from_json(d: dict) -> "ReconstructionDistribution":
        d = dict(d)
        cls = _DIST_REGISTRY[d.pop("type")]
        if cls is CompositeReconstructionDistribution:
            return cls(parts=[(int(n), ReconstructionDistribution.from_json(pd))
                              for n, pd in d.pop("parts")])
        if d.get("activation") is not None:
            d["activation"] = Activation(d["activation"])
        if d.get("loss") is not None:
            d["loss"] = LossFunction(d["loss"])
        return cls(**d)


@register_distribution
@dataclass
class GaussianReconstructionDistribution(ReconstructionDistribution):
    """N(mean, exp(log_var)) with diagonal covariance: input size 2 x the
    data's, split [mean | log var]."""

    TYPE = "gaussian"
    activation: Activation = Activation.IDENTITY

    def distribution_input_size(self, data_size: int) -> int:
        return 2 * data_size

    def _split(self, pre):
        n = pre.shape[-1] // 2
        return activation_fn(self.activation)(pre[..., :n]), pre[..., n:]

    def log_probability(self, x, pre):
        mean, log_var = self._split(pre)
        lp = (-_HALF_LOG_2PI - 0.5 * log_var
              - (x - mean) ** 2 / (2.0 * torch.exp(log_var)))
        return torch.sum(lp, dim=-1)

    def sample_mean(self, pre):
        return self._split(pre)[0]


@register_distribution
@dataclass
class BernoulliReconstructionDistribution(ReconstructionDistribution):
    """Bernoulli over binary data: input size = data size, sigmoid by
    default (then scored in the stable log-sigmoid form)."""

    TYPE = "bernoulli"
    activation: Activation = Activation.SIGMOID

    def distribution_input_size(self, data_size: int) -> int:
        return data_size

    def log_probability(self, x, pre):
        if self.activation == Activation.SIGMOID:
            lp = x * F.logsigmoid(pre) + (1.0 - x) * F.logsigmoid(-pre)
        else:
            p = torch.clamp(activation_fn(self.activation)(pre),
                            1e-7, 1.0 - 1e-7)
            lp = x * torch.log(p) + (1.0 - x) * torch.log(1.0 - p)
        return torch.sum(lp, dim=-1)

    def sample_mean(self, pre):
        return activation_fn(self.activation)(pre)


@register_distribution
@dataclass
class ExponentialReconstructionDistribution(ReconstructionDistribution):
    """Exponential(lambda), lambda = exp(gamma), gamma = activation(pre):
    log p = gamma - x exp(gamma)."""

    TYPE = "exponential"
    activation: Activation = Activation.IDENTITY

    def distribution_input_size(self, data_size: int) -> int:
        return data_size

    def log_probability(self, x, pre):
        gamma = activation_fn(self.activation)(pre)
        return torch.sum(gamma - x * torch.exp(gamma), dim=-1)

    def sample_mean(self, pre):
        return torch.exp(-activation_fn(self.activation)(pre))


def _per_example_loss(loss: LossFunction, labels, out) -> torch.Tensor:
    return torch.sum(_elementwise_loss(loss, labels, out), dim=-1)


@register_distribution
@dataclass
class LossFunctionWrapper(ReconstructionDistribution):
    """A standard loss as an unnormalised -log p(x|z): fine for
    pretraining, not for comparing log likelihoods."""

    TYPE = "loss_wrapper"
    loss: LossFunction = LossFunction.MSE
    activation: Activation = Activation.IDENTITY

    def distribution_input_size(self, data_size: int) -> int:
        return data_size

    def log_probability(self, x, pre):
        return -_per_example_loss(self.loss, x,
                                  activation_fn(self.activation)(pre))

    def sample_mean(self, pre):
        return activation_fn(self.activation)(pre)


@register_distribution
@dataclass
class CompositeReconstructionDistribution(ReconstructionDistribution):
    """Different distributions over disjoint feature slices: `parts` is a
    list of (data_size, distribution)."""

    TYPE = "composite"
    parts: List[Tuple[int, ReconstructionDistribution]] = field(
        default_factory=list)

    def add_distribution(self, size: int, dist: ReconstructionDistribution):
        self.parts.append((size, dist))
        return self

    def distribution_input_size(self, data_size: int) -> int:
        covered = sum(n for n, _ in self.parts)
        if data_size != covered:
            raise ValueError(f"composite parts cover {covered}, data has "
                             f"{data_size}")
        return sum(d.distribution_input_size(n) for n, d in self.parts)

    def log_probability(self, x, pre):
        lp, xi, pi = 0.0, 0, 0
        for n, d in self.parts:
            pn = d.distribution_input_size(n)
            lp = lp + d.log_probability(x[..., xi:xi + n],
                                        pre[..., pi:pi + pn])
            xi += n
            pi += pn
        return lp

    def sample_mean(self, pre):
        outs, pi = [], 0
        for n, d in self.parts:
            pn = d.distribution_input_size(n)
            outs.append(d.sample_mean(pre[..., pi:pi + pn]))
            pi += pn
        return torch.cat(outs, dim=-1)


# ---------------------------------------------------------------------------
# VAE layer


@register_layer
@dataclass
class VariationalAutoencoder(FeedForwardLayer):
    """VAE as a layer: n_out is the latent size. `forward` gives the mean
    of q(z|x) through the encoder; `pretrain_loss` is the negative ELBO
    with `num_samples` reparameterised draws."""

    TYPE = "vae"
    input_kind = "ff"
    n_in: int = 0
    n_out: int = 0
    encoder_layer_sizes: Tuple[int, ...] = (100,)
    decoder_layer_sizes: Tuple[int, ...] = (100,)
    pzx_activation: Activation = Activation.IDENTITY
    num_samples: int = 1
    reconstruction_distribution: ReconstructionDistribution = field(
        default_factory=GaussianReconstructionDistribution)

    def __post_init__(self):
        self.encoder_layer_sizes = tuple(self.encoder_layer_sizes)
        self.decoder_layer_sizes = tuple(self.decoder_layer_sizes)
        if isinstance(self.reconstruction_distribution, dict):
            self.reconstruction_distribution = \
                ReconstructionDistribution.from_json(
                    self.reconstruction_distribution)
        if isinstance(self.pzx_activation, str) \
                and not isinstance(self.pzx_activation, Activation):
            self.pzx_activation = Activation(self.pzx_activation)

    def output_type(self, it: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def init_params(self, gen, it, dtype=torch.float32) -> Params:
        """Drawn in the JAX package's order: encoder, z mean, z log
        variance, decoder, p(x|z)."""
        p: Params = {}
        zeros = lambda n: torch.zeros((n,), dtype=dtype, device=gen.device)

        def dense(wname, bname, a, b):
            p[wname] = self._winit(gen, (a, b), a, b, dtype)
            p[bname] = zeros(b)

        enc = [self.n_in] + list(self.encoder_layer_sizes)
        for i, (a, b) in enumerate(zip(enc[:-1], enc[1:])):
            dense(f"eW{i}", f"eb{i}", a, b)
        h = self.encoder_layer_sizes[-1]
        dense("ezMeanW", "ezMeanb", h, self.n_out)
        dense("ezLogVarW", "ezLogVarb", h, self.n_out)
        dec = [self.n_out] + list(self.decoder_layer_sizes)
        for i, (a, b) in enumerate(zip(dec[:-1], dec[1:])):
            dense(f"dW{i}", f"db{i}", a, b)
        n_dist = self.reconstruction_distribution.distribution_input_size(
            self.n_in)
        dense("pxzW", "pxzb", self.decoder_layer_sizes[-1], n_dist)
        return p

    def param_flags(self, name):
        # every weight's name holds a 'W' (eW0, ezMeanW, pxzW, ...)
        is_weight = "W" in name
        return {"is_bias": not is_weight, "regularizable": is_weight}

    # -- math -------------------------------------------------------------
    def _encode(self, params, x):
        act = self._act()
        h = x
        for i in range(len(self.encoder_layer_sizes)):
            h = act(h @ params[f"eW{i}"] + params[f"eb{i}"])
        mean = activation_fn(self.pzx_activation)(
            h @ params["ezMeanW"] + params["ezMeanb"])
        log_var = h @ params["ezLogVarW"] + params["ezLogVarb"]
        return mean, log_var

    def _decode(self, params, z):
        act = self._act()
        h = z
        for i in range(len(self.decoder_layer_sizes)):
            h = act(h @ params[f"dW{i}"] + params[f"db{i}"])
        return h @ params["pxzW"] + params["pxzb"]

    def _draw(self, mean, log_var, gen):
        eps = torch.randn(mean.shape, generator=gen, dtype=mean.dtype,
                          device=mean.device)
        return mean + torch.exp(0.5 * log_var) * eps

    def forward(self, params, x, *, train=False, rng=None, mask=None):
        x = self._maybe_dropout(x, train, rng)
        return self._encode(params, x)[0]

    def pretrain_loss(self, params, x, rng=None):
        """The negative ELBO averaged over the batch: KL(q(z|x) || N(0, I))
        minus the mean over `num_samples` draws of log p(x|z). rng=None:
        one draw with eps = 0."""
        mean, log_var = self._encode(params, x)
        kl = -0.5 * torch.sum(1.0 + log_var - mean ** 2 - torch.exp(log_var),
                              dim=-1)
        dist = self.reconstruction_distribution
        if rng is None:
            rec = dist.log_probability(x, self._decode(params, mean))
        else:
            rec = 0.0
            for _ in range(self.num_samples):
                z = self._draw(mean, log_var, rng)
                rec = rec + dist.log_probability(x, self._decode(params, z))
            rec = rec / self.num_samples
        return torch.mean(kl - rec)

    # -- user surface ------------------------------------------------------
    def reconstruction_probability(self, params, x, num_samples: int,
                                   rng) -> torch.Tensor:
        """Monte-Carlo estimate of log p(x) per example: the log of the
        mean over `num_samples` draws of p(x|z)."""
        mean, log_var = self._encode(params, x)
        lp = torch.stack([
            self.reconstruction_distribution.log_probability(
                x, self._decode(params, self._draw(mean, log_var, rng)))
            for _ in range(num_samples)])
        return torch.logsumexp(lp, dim=0) - math.log(num_samples)

    def generate_at_mean_given_z(self, params, z) -> torch.Tensor:
        """Latent -> E[x|z]."""
        return self.reconstruction_distribution.sample_mean(
            self._decode(params, z))
