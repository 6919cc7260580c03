"""Draft-verify speculative decoding for the paged decode engine
(counterpart of `deeplearning4j_tpu/serving/speculative.py`).

The decode engine emits ONE token per verified target-model step — at
serving shapes that step is bound by dispatch and cache bandwidth, so
the card spends most of each iteration on a single token's worth of
work. Speculative decoding (Leviathan et al., 2023) converts that slack
into tokens: a cheap DRAFT model proposes `k` candidate tokens per slot,
then the target model scores all proposals in ONE batched verify step —
a (k+1)-wide chunk per slot through the paged KV cache, the shape
`ops.attention.paged_attention_chunk_auto` already computes for chunked
prefill. Accepted tokens advance the slot; the first disagreement emits
the target's own token instead.

Exactness is the load-bearing contract, inherited per path:

- **greedy (temperature <= 0)**: a proposal is accepted only when it
  EQUALS the target's argmax at that position, and the stop position
  emits the target argmax itself — the emitted stream is the vanilla
  greedy rollout token for token, for ANY draft (a garbage draft only
  costs acceptance rate, never correctness).
- **sampled (temperature > 0)**: proposals drawn from the draft
  distribution q are accepted with probability min(1, p/q) against the
  target distribution p; the first rejection resamples from the
  residual norm(max(p - q, 0)), and a stop forced by anything OTHER
  than a rejection (all k accepted, or the slot nearing its token
  budget) draws from p directly. Each emitted token is distributed
  EXACTLY as a vanilla sample from p (Leviathan Thm. 1; the
  forced-stop draw is unbiased because it ignores the unconsumed
  accept coin). Draws come from per-slot `torch.Generator`s seeded per
  request: deterministic per seed, never equal to the JAX package's.

Rollback is free by construction: speculative KV writes land at
positions past each slot's committed length, where the engine's
position masking already hides them, and are overwritten in place when
decoding actually reaches those positions. Writes that would run past
a slot's reserved span (tail slots) are redirected to the trash page.

The draft model keeps its OWN paged KV pools indexed by the engine's
page table — same page ids, same refcounts, also when the draft is the
target itself — so prefix-cache hits skip the draft's prefill too, and
a page promotion shares both models' KV in one move.

Where the JAX package scans the k+1 draft steps inside one compiled
dispatch, this module loops in Python; the pools are updated in place.
Under tensor parallelism (`tp=`, the engine's `TPPlan`) the draft's and
the verify's block stacks run once per tp slot (`serving/tp_engine.py`):
a self-draft reuses the engine's split params, a separate draft gets
its own `TPPlan` (its geometry checked on its own), and the draft pools
are split over the slots' head axis like the engine's.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.models.transformer import (
    GPTPlan,
    _block_ffn,
    _block_heads,
    _block_out_proj,
    _prefill_block_attention,
    _top_k_filter,
)
from deeplearning4j_tpu_torch.serving.tp_engine import leaf0, run_blocks
from deeplearning4j_tpu_torch.ops.attention import (
    paged_attention_chunk_auto,
    paged_attention_step_auto,
)
from deeplearning4j_tpu_torch.serving.decode_engine import (
    _new_pools,
    _scales,
    _write_span,
    _write_step,
)


def resolve_draft_net(draft, target_net):
    """Materialize the `speculative={"draft": ...}` config value: a
    network instance is used as-is; the string "self" means
    self-speculation (draft = the target — every step still amortizes
    dispatches via the batched verify); a JSON config dict builds a
    fresh (randomly initialized) net on the target's device."""
    if draft is None:
        raise ValueError(
            'speculative={...} needs a "draft": a gpt net instance, '
            '"self", or a gpt_configuration JSON dict')
    if isinstance(draft, str):
        if draft != "self":
            raise ValueError(f'unknown speculative draft {draft!r} — '
                             'pass a net, "self", or a config dict')
        return target_net
    if isinstance(draft, dict):
        import json

        from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        net = MultiLayerNetwork(
            MultiLayerConfiguration.from_json(json.dumps(draft)),
            device=target_net.device)
        net.init()
        return net
    return draft


class SpeculativeDecoder:
    """Draft-propose + target-verify machinery for one `DecodeEngine`
    geometry. Built by the engine's `_build`; owns the draft model's
    paged KV pools and per-slot draft generators, reset alongside the
    engine's device state. `target_bparams` is the engine's
    compute-dtype copy of the target's parameters, reused when the
    draft is the target."""

    def __init__(self, *, target_plan, target_net, draft_net, k: int,
                 n_slots: int, page: int, L_logical: int,
                 pool_pages: int, top_k: int,
                 kv_quant: Optional[str] = None, target_bparams=None,
                 tp=None, tp_params=None):
        from deeplearning4j_tpu_torch.serving.tp_engine import TPPlan

        if k < 1:
            raise ValueError("speculative k must be >= 1")
        if tp is not None and not isinstance(tp, TPPlan):
            raise ValueError(f"tp must be the engine's TPPlan or None, got "
                             f"{type(tp).__name__}")
        # the engine's KV quantization mode is inherited verbatim: the
        # verify step writes into the ENGINE's pools, and the draft
        # pools mirror the same layout
        self._kv_quant = kv_quant
        self.k = int(k)
        self.n_slots = n_slots
        self.page = page
        self.pool_pages = pool_pages
        self.top_k = top_k
        self.L_logical = L_logical
        self.draft_net = draft_net
        self.device = target_net.device
        self.target_plan = target_plan
        # self-speculation still allocates its own draft pools
        # (reset_state): about twice the KV memory, as in the JAX package
        self.self_draft = draft_net is target_net
        self.draft_prefills = 0
        self.draft_chunk_prefills = 0
        if draft_net.device != self.device:
            raise ValueError(f"draft network lives on {draft_net.device}, "
                             f"the target on {self.device}")
        dplan = target_plan if self.self_draft else GPTPlan(draft_net)
        self.draft_plan = dplan
        if dplan.emb.n_in != target_plan.emb.n_in:
            raise ValueError(
                f"draft vocab {dplan.emb.n_in} != target vocab "
                f"{target_plan.emb.n_in} — speculative verification compares "
                "token ids, so the vocabularies must match")
        if dplan.emb.positional and dplan.emb.max_length < L_logical \
                and dplan.emb.max_length < target_plan.emb.max_length:
            raise ValueError(
                f"draft max_length {dplan.emb.max_length} is shorter than "
                f"the engine's logical cache ({L_logical}) — the draft "
                "could not embed positions the target serves")
        self._dparams = draft_net._params
        self._dbparams = target_bparams \
            if self.self_draft and target_bparams is not None \
            else dplan.cast_blocks(draft_net._params)
        # under tensor parallelism: a self-draft shares the engine's
        # split params, a separate draft is split by its own plan
        self._tp = tp
        if tp is None:
            self._dtp, self._dsparams = None, self._dbparams
        elif self.self_draft and tp_params is not None:
            self._dtp, self._dsparams = tp, tp_params
        else:
            self._dtp = TPPlan(draft_net, dplan, tp.degree)
            self._dsparams = self._dtp.shard_params(self._dbparams)
        self._rows = torch.arange(n_slots, device=self.device)
        self.reset_state()

    # -- device state ------------------------------------------------------
    def reset_state(self) -> None:
        """Fresh draft pools + per-slot draft generators (construction,
        post-failure recovery — always alongside the engine's own
        `_reset_device_state`, so draft and target pages can never skew)."""
        self._caches = _new_pools(self.draft_plan, self.pool_pages,
                                  self.page, self._kv_quant, self.device)
        if self._dtp is not None:
            self._caches = [tuple(self._dtp.shard_pool(x) for x in c)
                            for c in self._caches]
        self._gens: List[Optional[torch.Generator]] = [
            torch.Generator(device=self.device).manual_seed(1000 + i)
            for i in range(self.n_slots)]

    def seed_slot(self, slot: int, seed: int) -> None:
        """Per-request draft random stream (deterministic per seed, and
        another stream than the target's, which is seeded with `seed`)."""
        self._gens[slot] = torch.Generator(device=self.device).manual_seed(
            (int(seed) * 1_000_003 + 7) % (2 ** 63))

    def _embed(self, plan, bp, ids, positions):
        x = bp[plan.emb_i]["W"][ids]
        if plan.emb.positional:
            x = x + bp[plan.emb_i]["P"][
                positions.clamp(max=plan.emb.max_length - 1).long()]
        return x.to(plan.cdt)

    def _scale_and_filter(self, logits, temps_t):
        """Per-row temperature scale + the shared top-k truncation."""
        t = temps_t.to(logits.dtype)
        while t.ndim < logits.ndim:
            t = t[..., None]
        return _top_k_filter(logits / t, self.top_k)

    # -- draft prefill (one-shot + chunk): KV writes only, no head ---------
    @torch.no_grad()
    def prefill_one_shot(self, ids: np.ndarray, wpids) -> None:
        """Mirror one target one-shot prefill into the draft pools (same
        pages, same padded ids). Reads one scalar back so that a failed
        draft dispatch surfaces HERE, attributable, not inside a later
        verify."""
        dplan, dev, page = self.draft_plan, self.device, self.page
        P = ids.shape[1]
        qpos = torch.arange(P, device=dev)
        x = self._embed(dplan, self._dbparams,
                        torch.as_tensor(ids, device=dev), qpos)

        def blocks(bp, caches, x, shard, axis_name):
            for bi, i in enumerate(dplan.block_is):
                p, layer = bp[i], dplan.layers[i]
                q, kh, vh = _block_heads(layer, p, x, qpos, shard=shard)
                att = _prefill_block_attention(layer, q, kh, vh)
                x = _block_ffn(layer, p, x + _block_out_proj(
                    p, att.reshape(1, P, -1), axis_name), axis_name)
                _write_span(caches[bi], kh.permute(0, 2, 3, 1),
                            vh.permute(0, 2, 1, 3), wpids, 0, page)
            return x

        run_blocks(self._dtp, blocks, self._dsparams, self._caches, x)
        leaf0(self._caches[0][0])[0, 0, 0, 0].item()
        self.draft_prefills += 1

    @torch.no_grad()
    def prefill_chunk(self, page_row, ids: np.ndarray, off: int, woff: int,
                      pids) -> None:
        """Mirror one target prefill chunk into the draft pools."""
        dplan, dev, page = self.draft_plan, self.device, self.page
        Cw = ids.shape[1]
        qpos = off + torch.arange(Cw, device=dev)
        x = self._embed(dplan, self._dbparams,
                        torch.as_tensor(ids, device=dev), qpos)
        pos0 = torch.tensor([off], dtype=torch.int32, device=dev)

        def blocks(bp, caches, x, shard, axis_name):
            for bi, i in enumerate(dplan.block_is):
                p, layer = bp[i], dplan.layers[i]
                q, kh, vh = _block_heads(layer, p, x, qpos, shard=shard)
                cache = caches[bi]
                _write_span(cache, kh.permute(0, 2, 3, 1),
                            vh.permute(0, 2, 1, 3), pids, woff, page)
                att = paged_attention_chunk_auto(q, cache[0], cache[1],
                                                 page_row, pos0,
                                                 **_scales(cache))
                x = _block_ffn(layer, p, x + _block_out_proj(
                    p, att.reshape(1, Cw, -1), axis_name), axis_name)
            return x

        run_blocks(self._dtp, blocks, self._dsparams, self._caches, x)
        leaf0(self._caches[0][0])[0, 0, 0, 0].item()
        self.draft_chunk_prefills += 1

    # -- draft proposal: k+1 draft steps -----------------------------------
    def _write_targets(self, page_table, p_j, j: int, active, wlimit):
        """Pool page and in-page offset of position `p_j` per slot.
        Writes of inactive slots, and of positions past a slot's reserved
        span (`wlimit`), go to the trash page 0: speculative state never
        corrupts another request's pages."""
        wpos = p_j.clamp(max=self.L_logical - 1).long()
        writable = active if j == 0 else active & (p_j <= wlimit)
        pids = torch.where(
            writable, page_table[self._rows, wpos // self.page].long(), 0)
        return pids, wpos % self.page

    @torch.no_grad()
    def propose(self, page_table, tok, pos, temps: np.ndarray, active,
                active_np: np.ndarray, wlimit):
        """k proposals per slot plus one cache-completion step, so the
        draft's KV covers every position the NEXT round may start from
        (an all-accepted verify advances the slot past the k-th write).
        Returns `props` (S, k) int64 and the draft distributions `qd`
        (S, k, V) f32 the sampled slots drew from (None when every slot
        is greedy)."""
        dplan, bp = self.draft_plan, self._dbparams
        sampled = np.flatnonzero((temps > 0) & active_np)
        temps_t = None
        if sampled.size:
            temps_t = torch.as_tensor(np.where(temps > 0, temps, 1.0),
                                      device=self.device)
        cur, toks, qdists = tok, [], []
        for j in range(self.k + 1):
            p_j = pos + j
            x = self._embed(dplan, bp, cur, p_j)
            pids, loff = self._write_targets(page_table, p_j, j, active,
                                             wlimit)

            def blocks(bp, caches, x, shard, axis_name, p_j=p_j, pids=pids,
                       loff=loff):
                for bi, i in enumerate(dplan.block_is):
                    p, layer = bp[i], dplan.layers[i]
                    q, kh, vh = _block_heads(layer, p, x[:, None, :],
                                             p_j[:, None], shard=shard)
                    cache = caches[bi]
                    _write_step(cache, pids, loff, kh[:, 0], vh[:, 0])
                    att = paged_attention_step_auto(
                        q[:, 0], cache[0], cache[1], page_table, p_j,
                        active, **_scales(cache))
                    x = _block_ffn(layer, p, x + _block_out_proj(
                        p, att, axis_name), axis_name)
                return x

            x = run_blocks(self._dtp, blocks, self._dsparams, self._caches,
                           x)
            if j == self.k:
                break  # the completion step only writes the draft's KV
            logits = dplan.final_logits(bp, self._dparams, x)
            nxt = torch.argmax(logits, dim=-1)
            if sampled.size:
                qdist = torch.softmax(
                    self._scale_and_filter(logits, temps_t).float(), dim=-1)
                qdists.append(qdist)
                for s in sampled:
                    nxt[s] = torch.multinomial(qdist[s], 1,
                                               generator=self._gens[s])[0]
            cur = torch.where(active, nxt, cur)
            toks.append(cur)
        props = torch.stack(toks, dim=1)
        return props, (torch.stack(qdists, dim=1) if sampled.size else None)

    # -- target verify: one (k+1)-wide chunk per slot ----------------------
    @torch.no_grad()
    def verify(self, bp, params, caches, page_table, tok, pos,
               temps: np.ndarray, gens, active, active_np: np.ndarray,
               wlimit, props, qd):
        """Score [tok, props] per slot in one (k+1)-wide chunk through the
        engine's pools `caches` (written in place) and accept: greedy
        slots by argmax equality, sampled slots by Leviathan rejection
        sampling with the slot's generator `gens[s]`. Returns `new_tok`,
        `new_pos`, `out` (S, k+1) emitted tokens, `n_emit` (S,) and the
        per-slot finite flags."""
        tplan, kk, dev = self.target_plan, self.k, self.device
        C = kk + 1
        block = torch.cat([tok[:, None], props], dim=1)             # (S, C)
        qpos = pos[:, None] + torch.arange(C, device=dev,
                                           dtype=pos.dtype)[None, :]
        x = self._embed(tplan, bp, block, qpos)
        targets = [self._write_targets(page_table, pos + j, j, active,
                                       wlimit) for j in range(C)]

        def blocks(bp, caches, x, shard, axis_name):
            for bi, i in enumerate(tplan.block_is):
                p, layer = bp[i], tplan.layers[i]
                q, kh, vh = _block_heads(layer, p, x, qpos, shard=shard)
                cache = caches[bi]
                for j, (pids, loff) in enumerate(targets):
                    _write_step(cache, pids, loff, kh[:, j], vh[:, j])
                # one (k+1)-wide paged chunk per slot
                att = paged_attention_chunk_auto(q, cache[0], cache[1],
                                                 page_table, pos, active,
                                                 **_scales(cache))
                x = _block_ffn(layer, p, x + _block_out_proj(
                    p, att, axis_name), axis_name)
            return x

        x = run_blocks(self._tp, blocks, bp, caches, x)
        logits = tplan.final_logits(bp, params, x)                  # (S, C, V)

        # acceptance. Query j consumed [tok, props][j] and its
        # distribution governs the token at offset j+1.
        e = torch.argmax(logits, dim=-1)                            # (S, C)
        acc = e[:, :kk] == props
        acc_tok = e
        sampled = np.flatnonzero((temps > 0) & active_np)
        if sampled.size:
            idx = torch.as_tensor(sampled, device=dev)
            t_s = torch.as_tensor(temps[sampled], device=dev)
            scaled = self._scale_and_filter(logits[idx].float(), t_s)
            pdist = torch.softmax(scaled, dim=-1)                   # (n, C, V)
            qn = qd[idx]
            qn = torch.where(torch.isfinite(qn), qn, 0.0)
            pr = props[idx]
            us = torch.stack([torch.rand(kk, generator=gens[s], device=dev)
                              for s in sampled])
            p_at = torch.gather(pdist[:, :kk], -1, pr[..., None])[..., 0]
            q_at = torch.gather(qn, -1, pr[..., None])[..., 0]
            acc = acc.clone()
            acc[idx] = us < torch.clamp(p_at / q_at.clamp_min(1e-30), max=1.0)
            resid = (pdist[:, :kk] - qn).clamp_min(0.0)
            rsum = resid.sum(dim=-1, keepdim=True)
            resid = torch.where(rsum > 0, resid, pdist[:, :kk])
            # a rejection draws from the residual, a forced stop from the
            # full target distribution; one of the two is used per slot
            res_draws = torch.stack([
                torch.multinomial(resid[n], 1, generator=gens[s])[:, 0]
                for n, s in enumerate(sampled)])                    # (n, k)
            full_draws = torch.stack([
                torch.multinomial(pdist[n], 1, generator=gens[s])[:, 0]
                for n, s in enumerate(sampled)])                    # (n, C)
            acc_tok = e.clone()
            acc_tok[idx] = torch.cat([pr, pr[:, -1:]], dim=1)
        lead = torch.cumprod(acc.to(torch.int64), dim=1)
        m_rej = lead.sum(dim=1)                                     # 0..k
        # the slot's remaining write budget caps how deep this round may
        # commit; m_cap == 0 degrades the slot to a vanilla step
        m_cap = (wlimit - pos).clamp(0, kk).to(torch.int64)
        m = torch.minimum(m_rej, m_cap)
        m1 = m[:, None]
        fin = torch.gather(e, 1, m1)[:, 0]
        if sampled.size:
            # stop forced by the cap or by running out of proposals
            # (m_rej >= m_cap): the unconsumed accept coin is IGNORED and
            # the stop token samples from the full target distribution —
            # conditioning on it would bias the draw. A genuine rejection
            # (m_rej < m_cap) resamples the residual
            ms = m1[idx]
            forced = (m_rej >= m_cap)[idx]
            res_at_m = torch.gather(res_draws, 1, ms.clamp(max=kk - 1))[:, 0]
            full_at_m = torch.gather(full_draws, 1, ms)[:, 0]
            fin = fin.clone()
            fin[idx] = torch.where(forced, full_at_m, res_at_m)
        cidx = torch.arange(C, device=dev)[None, :]
        out = torch.where(cidx < m1, acc_tok, 0)
        out = torch.where(cidx == m1, fin[:, None], out)
        n_emit = torch.where(active, m + 1, 0)
        new_tok = torch.where(active, fin, tok)
        new_pos = torch.where(active, pos + (m + 1).to(pos.dtype), pos)
        row_ok = torch.isfinite(logits.float()).all(dim=-1).all(dim=-1)
        return new_tok, new_pos, out, n_emit, row_ok | ~active

    def stats(self) -> dict:
        return {"k": self.k, "draft_is_target": self.self_draft,
                "draft_prefills": self.draft_prefills,
                "draft_chunk_prefills": self.draft_chunk_prefills}
