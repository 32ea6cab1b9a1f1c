"""Speculative decoding: a draft model proposes, the target verifies, on
the device, with one host sync per burst.

Port of `dynamo_tpu/engine/spec.py` `spec_decode_multi_step` (`:87`). The
draft keeps its own paged caches at the target's page geometry, so one
page table serves both. Rollback costs nothing: rejected positions leave
stale K/V that attention masks by length until the next accepted tokens
overwrite them.

Each of `num_iters` iterations, for every lane:
- the draft runs gamma + 1 decode steps (`models/llama.py` `_decode_once`:
  K2 writes the row, K4 reads the cache); the last step's logits are
  unused but it writes d_gamma's K/V, so an all-accept iteration leaves
  no hole in the draft cache;
- the target runs one `paged_forward` over the gamma + 1 positions
  (K2 rows, K1 chunk rows on the card) and `lm_head` over every one;
- Leviathan rejection sampling on each lane's ACTUAL sampling
  distribution (`sampling.filtered_probs` after the penalties and the
  grammar mask, identical on both sides), so greedy lanes are the
  one-hot case (accept while the target's argmax equals the proposal)
  and every sampling configuration rides the same burst;
- the extra token: the residual max(p_t - p_d, 0) after a rejection, the
  target's own distribution after an all-accept.

The randomness is the reference's bit for bit: the draft's stream uses
the seeds XOR `DRAFT_SEED_SALT`, keyed fold_in(fold_in(seed, step), j);
the acceptance draw folds in 0x5EC0 and the extra token's 0xB0E5 at
step + n_acc (`sampling.uniform`, `sampling.categorical`).

Guided lanes carry the DFA state chain (the state after each proposal;
the verify position i is masked by the state after the first i
proposals, which is the accepted prefix's state), and penalty lanes a
tentative-counts chain built the same way; both resume from the accepted
prefix plus the extra token. No input tensor is written (the chains start
from copies), and nothing is read on the host, so one burst can be
captured in a CUDA graph and its warm-up run twice.
"""

from __future__ import annotations

from typing import Optional

import torch

from dynamo_tpu_torch.engine import sampling
from dynamo_tpu_torch.engine.quant import qm
from dynamo_tpu_torch.models.llama import LlamaModel, _decode_once, paged_forward

# XOR-ed into the seeds of the draft's sampling stream, so the draft and
# the target never draw the same (seed, step) randomness
DRAFT_SEED_SALT = 0x9E3779B9
_ACCEPT_SALT = 0x5EC0
_EXTRA_SALT = 0xB0E5
_NEG_INF = -1e30


def _lane_probs(logits: torch.Tensor, temperature: torch.Tensor,
                top_p: torch.Tensor, top_k: torch.Tensor,
                min_p: Optional[torch.Tensor] = None):
    """(probs, support) of `filtered_probs` over (B, V) or (B, G, V)
    logits (the reference's `_lane_probs`, `:60`); the support keeps the
    middle axis."""
    if logits.dim() == 2:
        return sampling.filtered_probs_support(logits, temperature, top_p,
                                               top_k, min_p)
    b, g, v = logits.shape

    def rep(x):
        return None if x is None else x.repeat_interleave(g)

    p, sup = sampling.filtered_probs_support(
        logits.reshape(b * g, v), rep(temperature), rep(top_p), rep(top_k),
        rep(min_p))
    return p.reshape(b, g, v), sup.reshape(b, g, -1)


def _key(seeds: torch.Tensor, steps: torch.Tensor, salt: int):
    """fold_in(fold_in(PRNGKey(seed), step), salt) per lane."""
    return sampling.fold_in(sampling.fold_in(sampling.prng_key(seeds),
                                             steps),
                            torch.full_like(steps, salt))


def spec_decode_multi_step(
        model: LlamaModel, draft: LlamaModel, k_cache: list, v_cache: list,
        dk_cache: list, dv_cache: list, tokens: torch.Tensor,
        positions: torch.Tensor, page_tables: torch.Tensor,
        valid: torch.Tensor, seeds: torch.Tensor, steps0: torch.Tensor,
        temperature: torch.Tensor, top_p: torch.Tensor, top_k: torch.Tensor,
        gamma: int, num_iters: int, topk_lp: int = 0,
        min_p: Optional[torch.Tensor] = None,
        guided: Optional[tuple] = None,
        penalties: Optional[tuple] = None
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """`num_iters` fused draft → verify → accept iterations.

    tokens / positions / valid / seeds / steps0 / temperature / top_p /
    top_k: (B,) as `decode_multi_step`'s; pages for positions ..
    positions + num_iters·(gamma+1) - 1 must be in `page_tables`. Both
    cache pairs are updated in place.

    min_p: (B,) or None. guided: None or (g_bits, g_next, g_eos_ok,
    g_ids, g_states, stop_ids) as `decode_multi_step_guided` takes them.
    penalties: None or (rep_pen, freq_pen, pres_pen, prompt_counts,
    out_counts) likewise.

    Returns (packed (3 + 2·topk_lp, num_iters, gamma+1, B) f32, new
    positions (B,)): rows token ids, the target's logprobs of them, each
    lane's emitted count (broadcast along gamma+1; slots at or past it
    are padding), then top-k ids and logprobs of the target's (masked)
    distribution at every verified position."""
    cfg = model.cfg
    B = tokens.shape[0]
    G1 = gamma + 1
    dev = tokens.device
    lanes = torch.arange(B, device=dev)
    seeds = seeds.long() & 0xFFFFFFFF
    draft_seeds = seeds ^ DRAFT_SEED_SALT
    greedy = temperature <= 0
    if guided is not None:
        g_bits, g_next, g_eos_ok, g_ids, g_states, stop_ids = guided
        is_stop = sampling.stop_token_mask(stop_ids, cfg.vocab_size)
        g_lane = g_ids.long()

        def allow_rows(states):
            return sampling.guided_allow(g_bits, g_eos_ok, g_ids, states,
                                         is_stop)

        def advance(states, toks):
            return g_next[g_lane, states, toks.long()].long()
    if penalties is not None:
        rep_pen, freq_pen, pres_pen, prompt_counts, out_counts = penalties
        add = valid.to(out_counts.dtype)

        def bump(counts, toks):
            counts = counts.clone()
            counts[lanes, toks.long()] += add
            return counts

    def head(logits, counts, allow):
        """Penalties, then the grammar mask."""
        if penalties is not None:
            logits = sampling.apply_penalties(logits, prompt_counts, counts,
                                              rep_pen, freq_pen, pres_pen)
        if allow is not None:
            logits = torch.where(allow, logits,
                                 torch.full_like(logits, _NEG_INF))
        return logits

    out = torch.zeros((3 + 2 * topk_lp, num_iters, G1, B),
                      dtype=torch.float32, device=dev)
    cur = tokens
    pos = positions
    steps = steps0.long() & 0xFFFFFFFF
    gst = g_states.long() if guided is not None else None
    oc = out_counts if penalties is not None else None
    for it in range(num_iters):
        # -- draft: gamma proposals, gamma + 1 forwards
        d_tokens = [cur]
        d_probs = []
        d_allows = []
        d_states = [gst]           # DFA state BEFORE proposal j + 1
        d_counts = [oc]            # tentative counts BEFORE proposal j + 1
        dtok, st, ct = cur, gst, oc
        for j in range(G1):
            dlogits = _decode_once(draft, dk_cache, dv_cache, dtok, pos + j,
                                   page_tables, valid)
            if j == gamma:
                break
            allow_j = allow_rows(st) if guided is not None else None
            dp, dsup = _lane_probs(head(dlogits, ct, allow_j), temperature,
                                   top_p, top_k, min_p)
            key = _key(draft_seeds, steps, j)
            stoch = sampling.categorical(key, dp, dsup)
            dtok = torch.where(greedy, torch.argmax(dp, dim=-1),
                               stoch).to(torch.int32)
            d_tokens.append(dtok)
            d_probs.append(dp)
            d_allows.append(allow_j)
            if guided is not None:
                st = advance(st, dtok)
            d_states.append(st)
            if penalties is not None:
                ct = bump(ct, dtok)
            d_counts.append(ct)
        verify = torch.stack(d_tokens, dim=1)                 # (B, G1)
        draft_p = torch.stack(d_probs, dim=1)                 # (B, gamma, V)

        # -- target: one forward over the G1 positions
        seq_lens = torch.where(valid, pos + G1, pos).to(torch.int32)
        x = paged_forward(model, k_cache, v_cache, verify, page_tables,
                          pos.to(torch.int32), seq_lens, False)
        logits = qm(x, model.lm_head).float()                 # (B, G1, V)
        V = logits.shape[-1]
        counts_stack = None
        if penalties is not None:
            counts_stack = torch.stack(d_counts, dim=1)       # (B, G1, V)
            logits = sampling.apply_penalties(
                logits.reshape(B * G1, V),
                prompt_counts.repeat_interleave(G1, dim=0),
                counts_stack.reshape(B * G1, V),
                rep_pen.repeat_interleave(G1),
                freq_pen.repeat_interleave(G1),
                pres_pen.repeat_interleave(G1)).reshape(B, G1, V)
        if guided is not None:
            allow_all = torch.stack(d_allows + [allow_rows(d_states[gamma])],
                                    dim=1)                    # (B, G1, V)
            logits = torch.where(allow_all, logits,
                                 torch.full_like(logits, _NEG_INF))
        target_p, t_sup = _lane_probs(logits, temperature, top_p, top_k,
                                      min_p)

        # -- acceptance
        cand = verify[:, 1:].long()                           # (B, gamma)
        p_t = torch.gather(target_p[:, :gamma], 2, cand[..., None])[..., 0]
        p_d = torch.gather(draft_p, 2, cand[..., None])[..., 0]
        u = sampling.uniform(_key(seeds, steps, _ACCEPT_SALT), gamma)
        ok = u * torch.clamp(p_d, min=1e-30) < p_t
        n_acc = torch.argmin(torch.cat(
            [ok, torch.zeros((B, 1), dtype=torch.bool, device=dev)],
            dim=1).to(torch.int32), dim=1)                    # leading trues

        # -- the extra token: a residual sample, or a bonus one
        pt_at_n = target_p[lanes, n_acc]                      # (B, V)
        pd_pad = torch.cat([draft_p, torch.zeros_like(draft_p[:, :1])],
                           dim=1)
        pd_at_n = pd_pad[lanes, n_acc]
        residual = torch.clamp(pt_at_n - pd_at_n, min=0.0)
        res_mass = residual.sum(dim=-1, keepdim=True)
        res_dist = torch.where(res_mass > 1e-9, residual / res_mass,
                               pt_at_n)
        dist = torch.where((n_acc == gamma)[:, None], pt_at_n, res_dist)
        stoch_x = sampling.categorical(
            _key(seeds, steps + n_acc, _EXTRA_SALT), dist, t_sup[lanes, n_acc])
        extra = torch.where(greedy, torch.argmax(dist, dim=-1), stoch_x)

        # -- emit
        slot = torch.arange(G1, device=dev)[None, :]
        emitted = torch.where(slot[:, :gamma] < n_acc[:, None], cand,
                              torch.zeros_like(cand))
        emitted = torch.cat([emitted, torch.zeros_like(emitted[:, :1])],
                            dim=1)
        emitted[lanes, n_acc] = extra
        count = n_acc + 1
        logp_all = torch.log_softmax(logits, dim=-1)
        chosen_lp = torch.gather(logp_all, 2, emitted[..., None])[..., 0]
        out[0, it] = emitted.T.float()
        out[1, it] = chosen_lp.T
        out[2, it] = count.float()[None, :].expand(G1, B)
        if topk_lp:
            tk_ids, tk_vals = sampling.stable_topk_logprobs(logp_all,
                                                            topk_lp)
            out[3:3 + topk_lp, it] = tk_ids.permute(2, 1, 0)
            out[3 + topk_lp:, it] = tk_vals.permute(2, 1, 0)

        last = emitted[lanes, n_acc]
        pos = torch.where(valid, pos + count, pos)
        steps = (steps + count) & 0xFFFFFFFF
        if guided is not None:
            st_at_n = torch.stack(d_states, dim=1)[lanes, n_acc]
            gst = advance(st_at_n, last)
        if penalties is not None:
            oc = bump(counts_stack[lanes, n_acc], last)
        cur = last.to(torch.int32)
    return out, pos
