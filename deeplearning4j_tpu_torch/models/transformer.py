"""GPT-style causal transformer language model (counterpart of
`deeplearning4j_tpu/models/transformer.py`).

`gpt_configuration` builds the same `MultiLayerConfiguration` as the JAX
package: token (+ learned positional) embedding -> N pre-LN
`TransformerBlock`s -> final LayerNorm -> per-timestep softmax head.

`GPTPlan` and the `_block_*` helpers are the one implementation of
per-token transformer compute, shared by whole-batch `generate` below
and by the continuous-batching `serving.decode_engine.DecodeEngine`, so
the engine's greedy tokens equal `generate`'s by construction.

Sampling: greedy (temperature <= 0) is argmax, first index on ties, as
`jnp.argmax`. Sampled decoding draws from an explicit `torch.Generator`
seeded with `seed`; it is deterministic per seed but never equal to the
JAX package's threefry draws.
"""
from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.conf import (
    InputType,
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.layers import (
    LayerNormalization,
    RnnOutputLayer,
    TokenEmbedding,
    TransformerBlock,
    ffn,
    layer_norm,
)
from deeplearning4j_tpu_torch.nn.updater import Updater
from deeplearning4j_tpu_torch.ops.activations import Activation
from deeplearning4j_tpu_torch.ops.kernel_dispatch import resolve_device
from deeplearning4j_tpu_torch.ops.losses import LossFunction


def gpt_configuration(vocab_size: int,
                      d_model: int = 256,
                      n_heads: int = 4,
                      n_layers: int = 4,
                      max_length: int = 512,
                      ffn_mult: int = 4,
                      dropout: float = 0.0,
                      seed: int = 12345,
                      learning_rate: float = 3e-4,
                      updater: Updater = Updater.ADAM,
                      attention_block_size: int = 1024,
                      moe_experts: int = 0,
                      remat: bool = False,
                      n_kv_heads: int = 0,
                      rope: bool = False,
                      ffn_activation: str = "gelu",
                      ) -> MultiLayerConfiguration:
    """Causal LM over int token ids (B, T). `n_kv_heads`: grouped-query
    attention (0 = full MHA). `rope`: rotary embeddings in every block
    and no learned positional table."""
    b = (NeuralNetConfiguration.Builder()
         .seed(seed)
         .learning_rate(learning_rate)
         .updater(updater)
         .drop_out(dropout)
         .list()
         .layer(TokenEmbedding(n_in=vocab_size, n_out=d_model,
                               max_length=max_length,
                               positional=not rope)))
    for _ in range(n_layers):
        b = b.layer(TransformerBlock(n_in=d_model, n_out=d_model,
                                     n_heads=n_heads, ffn_mult=ffn_mult,
                                     causal=True,
                                     block_size=attention_block_size,
                                     moe_experts=moe_experts,
                                     remat=remat, n_kv_heads=n_kv_heads,
                                     rope=rope,
                                     ffn_activation=ffn_activation))
    return (b
            .layer(LayerNormalization(n_in=d_model, n_out=d_model,
                                      dropout=0.0))
            .layer(RnnOutputLayer(n_in=d_model, n_out=vocab_size,
                                  activation=Activation.SOFTMAX,
                                  loss=LossFunction.MCXENT, dropout=0.0))
            .set_input_type(InputType.recurrent(vocab_size))
            .build())


# ---------------------------------------------------------------------------
# shared decode plan + per-block compute


class GPTPlan:
    """Static decode plan for a `gpt_configuration` network: layer
    indices, the embedding layer, and the precision policy (embedding,
    blocks and KV caches in the compute dtype; final LN statistics in
    f32; the logits head in the parameter dtype)."""

    def __init__(self, net):
        net._ensure_init()
        layers = net.layers
        if not isinstance(layers[0], TokenEmbedding):
            raise ValueError("generate() expects a gpt_configuration "
                             "network (TokenEmbedding first)")
        self.net = net
        self.layers = layers
        self.emb_i = 0
        self.emb = layers[0]
        self.block_is = [i for i, l in enumerate(layers)
                         if isinstance(l, TransformerBlock)]
        self.ln_is = [i for i, l in enumerate(layers)
                      if isinstance(l, LayerNormalization)]
        self.out_i = next(i for i, l in enumerate(layers)
                          if isinstance(l, RnnOutputLayer))
        self.dtype = net.dtype
        self.cdt = net.compute_dtype or net.dtype

    def kv_geometry(self):
        """Per-block (Hkv, head_dim) pairs: the KV-cache geometry."""
        return [(self.layers[i]._kv_heads,
                 self.layers[i].n_out // self.layers[i].n_heads)
                for i in self.block_is]

    def cast_blocks(self, params):
        """Embedding + block params in the compute dtype; head params
        stay in the param dtype."""
        if self.cdt == self.dtype:
            return params
        from deeplearning4j_tpu_torch.nn.precision import tree_cast

        return [tree_cast(p, self.cdt)
                if i in (self.emb_i, *self.block_is) else p
                for i, p in enumerate(params)]

    def final_logits(self, bp, params, x):
        """Trailing LN(s) in the compute dtype (statistics in f32), then
        the output head in the param dtype."""
        for i in self.ln_is:
            if i > max(self.block_is, default=-1):
                x = layer_norm(x, bp[i]["gamma"], bp[i]["beta"],
                               self.layers[i].eps)
        x = x.to(self.dtype)
        return x @ params[self.out_i]["W"] + params[self.out_i]["b"]


def _block_heads(layer, p, x, positions=None):
    """(..., d) -> q (..., H, hd) and k/v (..., Hkv, hd) for one block;
    under RoPE q and k are rotated at `positions`."""
    d = x.shape[-1]
    H, Hkv = layer.n_heads, layer._kv_heads
    hd = d // H
    qw, kvw = H * hd, Hkv * hd
    h1 = layer_norm(x, p["ln1_g"], p["ln1_b"], layer.eps)
    qkv = h1 @ p["Wqkv"] + p["bqkv"]
    lead = x.shape[:-1]
    q = qkv[..., :qw].reshape(*lead, H, hd)
    k = qkv[..., qw:qw + kvw].reshape(*lead, Hkv, hd)
    v = qkv[..., qw + kvw:].reshape(*lead, Hkv, hd)
    if layer.rope:
        from deeplearning4j_tpu_torch.ops.rope import rope_angles, rope_rotate

        cos, sin = rope_angles(positions, hd, layer.rope_base,
                               device=x.device)
        q = rope_rotate(q, cos, sin)
        k = rope_rotate(k, cos, sin)
    return q, k, v


def _block_out_proj(p, att):
    """Attention output projection on flattened head outputs (..., H*hd)."""
    return att @ p["Wo"] + p["bo"]


def _block_ffn(layer, p, x):
    """Post-attention half of the block: x + FFN(LN2(x)). An MoE block
    routes the call's tokens (all of a prefill, one per row of a decode
    step) among its experts with the inference capacity, no aux loss."""
    return x + ffn(layer, p, x)


def _top_k_filter(logits, top_k: int):
    """Mask everything below the k-th largest logit per row."""
    if top_k <= 0:
        return logits
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def _sample_logits(logits, generator, temperature: float, top_k: int):
    """Greedy argmax when temperature <= 0, else temperature/top-k
    categorical sampling from `generator`. Returns int64 ids."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    scaled = _top_k_filter(logits.float() / temperature, top_k)
    probs = torch.softmax(scaled, dim=-1)
    return torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1,
                             generator=generator).reshape(probs.shape[:-1])


def _prefill_block_attention(layer, q, k, v):
    """Causal prefill attention for one block; GQA K/V widened to the
    full head count (training-path semantics)."""
    from deeplearning4j_tpu_torch.ops.attention import full_attention

    if layer._kv_heads != layer.n_heads:
        g = layer.n_heads // layer._kv_heads
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
    return full_attention(q, k, v, causal=True)


@torch.no_grad()
def generate(net, prompt_ids, n_tokens: int, temperature: float = 1.0,
             top_k: int = 0, seed: int = 0, include_prompt: bool = False,
             device="cuda"):
    """Whole-batch autoregressive sampler for a `gpt_configuration`
    network: one prefill over the prompts, then one decode step per
    token against dense per-block KV caches (K (B, Hkv, hd, L),
    V (B, Hkv, L, hd)). Every sequence decodes `n_tokens` in lockstep.

    `device` defaults to the card and must be the network's device.
    Returns (B, n_tokens) int32 numpy ids (prompt prepended with
    `include_prompt`)."""
    from deeplearning4j_tpu_torch.ops.attention import cached_attention_step

    dev = resolve_device(device)
    if dev != net.device:
        raise ValueError(f"generate on {dev} but the network lives on "
                         f"{net.device}")
    plan = GPTPlan(net)
    layers, emb, cdt = plan.layers, plan.emb, plan.cdt
    prompt = np.asarray(prompt_ids)
    if prompt.ndim == 1:
        prompt = prompt[None, :]
    B, T0 = prompt.shape
    L = T0 + n_tokens
    if emb.positional and L > emb.max_length:
        raise ValueError(f"prompt ({T0}) + n_tokens ({n_tokens}) exceeds "
                         f"max_length {emb.max_length}")
    if n_tokens == 0:
        return prompt.astype(np.int32) if include_prompt \
            else np.zeros((B, 0), np.int32)
    params = net._params
    bp = plan.cast_blocks(params)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    ids = torch.as_tensor(prompt.astype(np.int64), device=dev)

    # prefill
    x = bp[0]["W"][ids]
    if emb.positional:
        x = x + bp[0]["P"][:T0]
    x = x.to(cdt)
    caches = []
    for i in plan.block_is:
        p, layer = bp[i], layers[i]
        q, k, v = _block_heads(layer, p, x, torch.arange(T0, device=dev))
        att = _prefill_block_attention(layer, q, k, v)
        x = _block_ffn(layer, p, x + _block_out_proj(p, att.reshape(B, T0, -1)))
        Hkv, hd = k.shape[2], k.shape[3]
        kc = torch.zeros((B, Hkv, hd, L), dtype=k.dtype, device=dev)
        vc = torch.zeros((B, Hkv, L, hd), dtype=v.dtype, device=dev)
        kc[..., :T0] = k.permute(0, 2, 3, 1)
        vc[:, :, :T0] = v.permute(0, 2, 1, 3)
        caches.append((kc, vc))
    tok = _sample_logits(plan.final_logits(bp, params, x[:, -1]), gen,
                         temperature, top_k)
    out = [tok]

    # decode: each step consumes the previous token at position pos
    for t in range(n_tokens - 1):
        pos = T0 + t
        x = bp[0]["W"][tok]
        if emb.positional:
            x = x + bp[0]["P"][pos]
        x = x.to(cdt)
        for bi, i in enumerate(plan.block_is):
            p, layer = bp[i], layers[i]
            q, k, v = _block_heads(layer, p, x[:, None, :], pos)
            q, k, v = q[:, 0], k[:, 0], v[:, 0]
            kc, vc = caches[bi]
            kc[..., pos] = k   # in place: the caches live for the whole call
            vc[:, :, pos] = v
            att = cached_attention_step(q, kc, vc, pos)
            x = _block_ffn(layer, p, x + _block_out_proj(p, att))
        tok = _sample_logits(plan.final_logits(bp, params, x), gen,
                             temperature, top_k)
        out.append(tok)
    gen_ids = torch.stack(out, dim=1).to(torch.int32).cpu().numpy()
    return np.concatenate([prompt.astype(np.int32), gen_ids], axis=1) \
        if include_prompt else gen_ids
