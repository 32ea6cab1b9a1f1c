"""Batched token sampling: greedy / temperature / top-k / top-p / min_p.

Port of `dynamo_tpu/engine/sampling.py` (`_candidate_mask` `:27`,
`filtered_probs` `:57`, `sample_tokens_traced` `:78`, the constrained
head — `apply_penalties` `:106`, `stop_token_mask` `:127`, `guided_allow`
`:135`, `constrained_logits` `:154` — `chosen_logprob`,
`stable_topk_logprobs` `:177`, `topk_logprobs` and
`_sample_tokens_lp_traced` `:169-219`), and what speculative decoding
draws from a filtered distribution (`categorical`, `uniform`: the
reference's `spec.py` `_categorical` `:78` and its acceptance draw
`jax.random.uniform(key, (gamma,))` `:273`). All knobs are per-row tensors so
one call serves a mixed batch. Randomness comes from (seed, step) pairs,
so replays and migrations are deterministic.

Seeded sampling reproduces the reference's bits exactly: it is
`jax.random.categorical(fold_in(PRNGKey(seed), step), logits / t)`, so
this module carries threefry-2x32, `PRNGKey`, `fold_in`, jax's
"partitionable" random-bits layout (the default since jax 0.5; the
installed reference is jax 0.9.0), the bits→uniform conversion and the
Gumbel-max draw. uint32 arithmetic runs in int64 masked with 0xFFFFFFFF,
because torch's uint32 support is incomplete on CUDA.

Candidates: like the reference, the MAX_CANDIDATES highest logits are
kept (sorted, ties by lowest index, as `lax.top_k`), and top-k/top-p/min_p
and sampling run on that truncated set; greedy is a full argmax.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

_NEG_INF = -1e30
MAX_CANDIDATES = 64
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = float(torch.finfo(torch.float32).tiny)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) on int64 tensors holding uint32 values;
    broadcasts like the reference primitive."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def prng_key(seed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`jax.random.PRNGKey` of uint32 seeds: the key pair (0, seed)."""
    seed = seed.long() & _M32
    return torch.zeros_like(seed), seed


def fold_in(key: tuple[torch.Tensor, torch.Tensor],
            data: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`jax.random.fold_in`: threefry of the count pair (0, data)."""
    data = data.long() & _M32
    return threefry2x32(key[0], key[1], torch.zeros_like(data), data)


def random_bits(key: tuple[torch.Tensor, torch.Tensor],
                n: int) -> torch.Tensor:
    """`jax.random.bits(key, (n,), uint32)` per key row ((B,) keys →
    (B, n)): the partitionable layout, threefry over the 64-bit iota
    (hi, lo) counts, words XOR-folded."""
    lo = torch.arange(n, dtype=torch.int64, device=key[0].device)[None, :]
    return random_bits_at(key, lo)


def random_bits_at(key: tuple[torch.Tensor, torch.Tensor],
                   idx: torch.Tensor) -> torch.Tensor:
    """Words `idx` (B, n) (any indices below 2^32) of each key row's
    `random_bits` stream, without drawing the words before them."""
    k1, k2 = key[0][:, None], key[1][:, None]
    lo = idx.long()
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return b1 ^ b2


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """`jax.random.uniform(minval=tiny, maxval=1.)` in float32 from raw
    32-bit words: mantissa fill of [1, 2), minus 1, affine, clamp."""
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    # torch.full, not torch.tensor: no host-to-device copy (which would
    # synchronise the stream on every sampling step of a burst)
    tiny = torch.full((), _F32_TINY, dtype=torch.float32, device=bits.device)
    return torch.maximum(tiny, floats * (1.0 - tiny) + tiny)


def gumbel(key: tuple[torch.Tensor, torch.Tensor], n: int) -> torch.Tensor:
    """`jax.random.gumbel(key, (n,), float32)` (mode "low") per key row."""
    return -torch.log(-torch.log(uniform_from_bits(random_bits(key, n))))


def uniform(key: tuple[torch.Tensor, torch.Tensor], n: int) -> torch.Tensor:
    """`jax.random.uniform(key, (n,))` per key row: minval 0, so unlike
    the Gumbel draw's `uniform_from_bits` there is no floor at `tiny`."""
    fbits = ((random_bits(key, n) >> 9) | 0x3F800000).to(torch.int32)
    return fbits.view(torch.float32) - 1.0


def categorical(key: tuple[torch.Tensor, torch.Tensor], probs: torch.Tensor,
                support: torch.Tensor) -> torch.Tensor:
    """The reference's `jax.random.categorical(key, log(max(p, 1e-30)))`
    over each (V,) row of `probs` (B, V), computed on `support` (B, C):
    indices that hold every nonzero entry of the row. A Gumbel draw is
    at most 15.9 and at least -4.5, so an entry at the 1e-30 floor
    (log -69.1) never beats a supported one (some entry of C <= 64 has
    p >= 1/64): the argmax over V is the argmax over the support, with
    the stream's words taken at those indices and ties to the lowest
    index, as over V."""
    p = torch.gather(probs, 1, support)
    g = -torch.log(-torch.log(uniform_from_bits(random_bits_at(key,
                                                               support))))
    val = g + torch.log(torch.clamp(p, min=1e-30))
    best = val.max(dim=-1, keepdim=True).values
    return torch.where(val == best, support.long(),
                       torch.full_like(support.long(), 1 << 40)).amin(-1)


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`lax.top_k` over the last axis: sorted descending, ties broken by
    the lowest index (a stable sort guarantees it; torch.topk does not)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _candidate_mask(logits: torch.Tensor, temperature: torch.Tensor,
                    top_p: torch.Tensor, top_k: torch.Tensor,
                    min_p: Optional[torch.Tensor] = None):
    """THE filter definition (top-k → top-p → min_p over the sorted
    candidate set): returns (masked_cand_logits (B, C), cand_idx (B, C),
    t (B,))."""
    b, v = logits.shape
    c = min(MAX_CANDIDATES, v)
    cand_logits, cand_idx = _top_k(logits, c)
    k_eff = torch.clamp(torch.where(top_k > 0, top_k, c), 1, c)
    pos = torch.arange(c, device=logits.device)
    neg = torch.full_like(cand_logits, _NEG_INF)
    masked = torch.where(pos[None, :] < k_eff[:, None], cand_logits, neg)
    # `<=` keeps index 0 even at top_p = 0 (never an all-masked row)
    t = torch.where(temperature > 0, temperature,
                    torch.ones_like(temperature))
    probs = torch.softmax(masked / t[:, None], dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) <= top_p[:, None]
    if min_p is not None:
        keep &= probs >= torch.clamp(min_p, 0.0, 1.0)[:, None] \
            * probs[:, :1]
    return torch.where(keep, masked, neg), cand_idx, t


def filtered_probs(logits: torch.Tensor, temperature: torch.Tensor,
                   top_p: torch.Tensor, top_k: torch.Tensor,
                   min_p: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, V) probabilities of the distribution a row is sampled from:
    the temperature-scaled softmax over the kept candidates (zeros
    elsewhere); temperature == 0 rows are the one-hot argmax."""
    return filtered_probs_support(logits, temperature, top_p, top_k,
                                  min_p)[0]


def filtered_probs_support(logits: torch.Tensor, temperature: torch.Tensor,
                           top_p: torch.Tensor, top_k: torch.Tensor,
                           min_p: Optional[torch.Tensor] = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(`filtered_probs`, the (B, C) candidate indices that hold its
    nonzero entries) — the support `categorical` draws on."""
    b, v = logits.shape
    masked, cand_idx, t = _candidate_mask(logits, temperature, top_p,
                                          top_k, min_p)
    cand_p = torch.softmax(masked / t[:, None], dim=-1)      # (B, C)
    hard = F.one_hot(torch.argmax(masked, dim=-1),
                     masked.shape[-1]).to(torch.float32)
    cand_p = torch.where((temperature > 0)[:, None], cand_p, hard)
    full = torch.zeros((b, v), dtype=torch.float32, device=logits.device)
    return full.scatter_add_(1, cand_idx, cand_p), cand_idx


def sample_tokens(logits: torch.Tensor, seeds: torch.Tensor,
                  steps: torch.Tensor, temperature: torch.Tensor,
                  top_p: torch.Tensor, top_k: torch.Tensor,
                  min_p: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits: (B, V) fp32; seeds/steps: (B,) int64 (uint32 values);
    temperature/top_p: (B,) f32; top_k: (B,) int (0 = disabled); min_p:
    (B,) f32 or None. temperature <= 0 ⇒ greedy. Returns (B,) int64."""
    greedy = torch.argmax(logits, dim=-1)
    masked, cand_idx, t = _candidate_mask(logits, temperature, top_p,
                                          top_k, min_p)
    key = fold_in(prng_key(seeds), steps)
    g = gumbel(key, masked.shape[-1])
    choice = torch.argmax(g + masked / t[:, None], dim=-1)
    sampled = torch.gather(cand_idx, 1, choice[:, None])[:, 0]
    return torch.where(temperature > 0, sampled, greedy)


def apply_penalties(logits: torch.Tensor, prompt_counts: torch.Tensor,
                    out_counts: torch.Tensor, repetition: torch.Tensor,
                    frequency: torch.Tensor,
                    presence: torch.Tensor) -> torch.Tensor:
    """OpenAI/HF sampling penalties on (B, V) f32 logits, with
    prompt_counts / out_counts (B, V) token counts in the prompt and the
    output (vLLM's semantics): the repetition penalty (HF) divides the
    positive and multiplies the negative logits of every prompt or output
    token; the frequency and presence penalties (OpenAI) subtract for
    output tokens only."""
    seen = (prompt_counts + out_counts) > 0
    rep = repetition[:, None]
    rep_adj = torch.where(logits > 0, logits / rep, logits * rep)
    logits = torch.where(seen & (rep != 1.0), rep_adj, logits)
    logits = logits - frequency[:, None] * out_counts.to(logits.dtype)
    return logits - presence[:, None] * (out_counts > 0).to(logits.dtype)


def stop_token_mask(stop_ids: torch.Tensor, vocab: int) -> torch.Tensor:
    """(B, V) bool from (B, K) per-lane stop-token ids (-1 padding): which
    vocab entries are the lane's stop tokens."""
    ids = torch.arange(vocab, dtype=stop_ids.dtype, device=stop_ids.device)
    return (ids[None, None, :] == stop_ids[:, :, None]).any(dim=1)


def guided_allow(g_bits: torch.Tensor, g_eos_ok: torch.Tensor,
                 g_ids: torch.Tensor, states: torch.Tensor,
                 is_stop: torch.Tensor) -> torch.Tensor:
    """(B, V) bool: the tokens each lane's grammar permits in its state —
    the (G, S, ceil(V/8)) uint8 rows unpacked little-endian, plus the
    lane's stop tokens where `g_eos_ok` holds."""
    V = is_stop.shape[-1]
    dev = is_stop.device
    byte_idx = torch.arange(V, device=dev) // 8
    bit_idx = (torch.arange(V, device=dev) % 8).to(torch.uint8)
    gi, si = g_ids.long(), states.long()
    rows = g_bits[gi, si]                                # (B, ceil(V/8))
    allowed = (rows[:, byte_idx] >> bit_idx) & 1
    return (allowed > 0) | (g_eos_ok[gi, si][:, None] & is_stop)


def constrained_logits(logits: torch.Tensor, prompt_counts: torch.Tensor,
                       counts: torch.Tensor, rep: torch.Tensor,
                       freq: torch.Tensor, pres: torch.Tensor,
                       g_bits: torch.Tensor, g_eos_ok: torch.Tensor,
                       g_ids: torch.Tensor, states: torch.Tensor,
                       is_stop: torch.Tensor) -> torch.Tensor:
    """The constrained head before sampling: penalties, then the grammar
    mask (masked entries set to -1e30)."""
    logits = apply_penalties(logits, prompt_counts, counts, rep, freq, pres)
    allow = guided_allow(g_bits, g_eos_ok, g_ids, states, is_stop)
    return torch.where(allow, logits, torch.full_like(logits, _NEG_INF))


def chosen_logprob(logits: torch.Tensor,
                   sampled: torch.Tensor) -> torch.Tensor:
    """(B,) log-probability of each row's sampled token."""
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, 1, sampled[:, None].long())[:, 0]


def stable_topk_logprobs(logp: torch.Tensor,
                         k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """((..., k) ids f32, (..., k) logprobs), selected by logp rounded to
    bf16 with ties to the lowest index: alternatives closer than a bf16
    ulp keep their index order however their last bits fall, while the
    values reported are the exact f32 ones."""
    key = logp.to(torch.bfloat16).to(torch.float32)
    _, ids = _top_k(key, k)
    return ids.float(), torch.gather(logp, -1, ids)


def topk_logprobs(logits: torch.Tensor,
                  k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """((B, k) ids f32, (B, k) logprobs) of the k most likely tokens,
    exact-f32 order (OpenAI promises descending values)."""
    logp = torch.log_softmax(logits, dim=-1)
    vals, ids = _top_k(logp, k)
    return ids.float(), vals


def sample_tokens_lp(logits: torch.Tensor, seeds: torch.Tensor,
                     steps: torch.Tensor, temperature: torch.Tensor,
                     top_p: torch.Tensor, top_k: torch.Tensor,
                     min_p: Optional[torch.Tensor] = None,
                     topk_lp: int = 0) -> torch.Tensor:
    """sample_tokens + chosen-token logprob (+ top-k alternatives),
    PACKED (2 + 2*topk_lp, B) f32 — rows [sampled, chosen_lp, topk
    ids..., topk lps...]; token ids are exact in f32 (vocab « 2^24)."""
    sampled = sample_tokens(logits, seeds, steps, temperature, top_p,
                            top_k, min_p)
    rows = [sampled.float(), chosen_logprob(logits, sampled)]
    if topk_lp:
        ids, vals = topk_logprobs(logits, topk_lp)
        rows += [ids[:, i] for i in range(topk_lp)]
        rows += [vals[:, i] for i in range(topk_lp)]
    return torch.stack(rows)
