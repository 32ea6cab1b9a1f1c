"""Guided decoding: regex/choice/JSON grammars → token-level DFA tables.

Port of `dynamo_tpu/llm/guided.py` (numpy only; the port keeps its own
copy): the regex → NFA → DFA compiler (`compile_regex`, `minimize`), the
choice / JSON / JSON-schema grammars, the token-level `GuidedTables`
(`token_tables`), the tokenizer byte map (`token_bytes_of`, the byte
tokenizer and the HF branch) and `compile_guided`. The tables are
byte-identical with the reference's.

Reference surface: `lib/llm/src/protocols/common.rs:336`
(GuidedDecodingOptions: guided_json / guided_regex / guided_choice /
guided_grammar, enforcement delegated to the engine's xgrammar). We own
the engine, so enforcement is native:

- a small OWN regex engine (subset: literals, ``.``, ``[...]`` classes,
  ``* + ? | ( )``, ``{m,n}``, escapes) compiles to a byte-level NFA →
  DFA (subset construction);
- the DFA is lifted to TOKEN level against the serving tokenizer's
  vocabulary: for every DFA state, which token ids keep the automaton
  alive (packed bitmask) and where each token leads (next-state table);
- the engine uploads the per-grammar tables once ((S, V) int16 +
  (S, ceil(V/8)) uint8 — e.g. a 256-state grammar over a 32k vocab is
  ~17 MB) and the FUSED decode burst masks logits + advances lane
  states entirely on device — guided lanes cost one gather per step,
  not a host round-trip (sampling.py guided path).

``guided_choice`` compiles exactly (alternation of literals);
``guided_json`` (and ``response_format: json_object``) compiles a
bounded-nesting JSON grammar (depth 4 by default) — the classic
regular approximation of a context-free grammar (same approach as
outlines); deeper nesting is rejected mid-generation by the mask.

A sequence is complete when its state is ACCEPTING; EOS is only allowed
in accepting states, and when a state has no live continuation the mask
forces EOS.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np

# construction-time cap (pre-minimization; the bounded-depth JSON
# grammar peaks ~10k raw states and minimizes several-fold — depth 3 is
# 2843 → 342). The post-minimization cap is the int16 state table.
MAX_DFA_STATES = 50_000
DEAD = -1


# ---------------------------------------------------------------------------
# regex subset → NFA (Thompson construction over BYTES)
# ---------------------------------------------------------------------------


class GrammarError(ValueError):
    pass


@dataclasses.dataclass
class _Frag:
    start: int
    outs: list[int]          # state ids with a dangling ε-out


class _Nfa:
    """ε-NFA: states have byte-set transitions + ε edges.

    MAX_STATES bounds TOTAL construction work: per-bound caps alone
    don't, because stacked/nested {m,n} compose multiplicatively
    (a{256}{256} would clone 65k sub-NFAs) and guided_regex is
    user-supplied via the API — the compile thread must never hang."""

    MAX_STATES = 100_000

    def __init__(self) -> None:
        self.eps: list[list[int]] = []
        self.edges: list[list[tuple[frozenset, int]]] = []

    def new_state(self) -> int:
        if len(self.eps) >= self.MAX_STATES:
            raise GrammarError(
                f"regex too large (more than {self.MAX_STATES} NFA "
                f"states; reduce nested/stacked repetition bounds)")
        self.eps.append([])
        self.edges.append([])
        return len(self.eps) - 1


class _RegexParser:
    """Recursive-descent parser for the supported regex subset."""

    def __init__(self, pattern: str) -> None:
        self.p = pattern
        self.i = 0
        self.nfa = _Nfa()

    def parse(self) -> tuple[_Nfa, int, int]:
        start, accept = self.nfa.new_state(), self.nfa.new_state()
        frag = self._alt()
        if self.i != len(self.p):
            raise GrammarError(f"unexpected {self.p[self.i]!r} at "
                               f"{self.i} in regex")
        self.nfa.eps[start].append(frag.start)
        for o in frag.outs:
            self.nfa.eps[o].append(accept)
        return self.nfa, start, accept

    # grammar: alt := concat ('|' concat)* ; concat := rep* ;
    # rep := atom ('*'|'+'|'?'|'{m,n}')?

    def _alt(self) -> _Frag:
        frags = [self._concat()]
        while self.i < len(self.p) and self.p[self.i] == "|":
            self.i += 1
            frags.append(self._concat())
        if len(frags) == 1:
            return frags[0]
        s = self.nfa.new_state()
        outs = []
        for f in frags:
            self.nfa.eps[s].append(f.start)
            outs += f.outs
        return _Frag(s, outs)

    def _concat(self) -> _Frag:
        frags = []
        while self.i < len(self.p) and self.p[self.i] not in "|)":
            frags.append(self._rep())
        if not frags:
            s = self.nfa.new_state()
            return _Frag(s, [s])
        for a, b in zip(frags, frags[1:]):
            for o in a.outs:
                self.nfa.eps[o].append(b.start)
        return _Frag(frags[0].start, frags[-1].outs)

    def _rep(self) -> _Frag:
        a0 = self.i
        f = self._atom()
        while self.i < len(self.p) and self.p[self.i] in "*+?{":
            c = self.p[self.i]
            if c == "{":
                # re-parse span covers everything applied so far (atom +
                # any stacked quantifiers), so a*{2} means (a*){2}, not a{2}
                span = self.p[a0:self.i]
                m, n = self._bounds()
                f = self._repeat(span, m, n)
                continue
            self.i += 1
            if c == "*":
                s = self.nfa.new_state()
                self.nfa.eps[s].append(f.start)
                for o in f.outs:
                    self.nfa.eps[o].append(s)
                f = _Frag(s, [s])
            elif c == "+":
                s = self.nfa.new_state()
                for o in f.outs:
                    self.nfa.eps[o].append(s)
                self.nfa.eps[s].append(f.start)
                f = _Frag(f.start, [s])
            else:  # ?
                s = self.nfa.new_state()
                self.nfa.eps[s].append(f.start)
                f = _Frag(s, f.outs + [s])
        return f

    def _bounds(self) -> tuple[int, Optional[int]]:
        """{m}, {m,}, {m,n}. Returns (m, n) with n=None for open."""
        j = self.p.find("}", self.i)
        if j < 0:
            raise GrammarError("unclosed {m,n} bounds")
        body = self.p[self.i + 1:j]
        self.i = j + 1
        try:
            if "," in body:
                lo, hi = body.split(",", 1)
                return int(lo or 0), (int(hi) if hi.strip() else None)
            return int(body), int(body)
        except ValueError:
            raise GrammarError(f"bad repetition bounds {{{body}}}")

    def _clone(self, src: str) -> _Frag:
        """Re-parse an atom's source span into a fresh fragment (NFA
        fragments are single-use, so {m,n} expansion re-parses)."""
        save_p, save_i = self.p, self.i
        self.p, self.i = src, 0
        try:
            f = self._alt()
            if self.i != len(src):
                raise GrammarError(f"bad atom {src!r}")
            return f
        finally:
            self.p, self.i = save_p, save_i

    def _repeat(self, src: str, m: int, n: Optional[int]) -> _Frag:
        if m < 0 or (n is not None and n < m):
            raise GrammarError(f"bad repetition bounds {{{m},{n}}}")
        if (n or m) > 256:
            raise GrammarError("repetition bound too large (max 256)")
        frags = [self._clone(src) for _ in range(m)]
        if n is None:
            # {m,} = m copies + one starred copy
            star_body = self._clone(src)
            s = self.nfa.new_state()
            self.nfa.eps[s].append(star_body.start)
            for o in star_body.outs:
                self.nfa.eps[o].append(s)
            frags.append(_Frag(s, [s]))
        else:
            for _ in range(n - m):
                opt = self._clone(src)
                s = self.nfa.new_state()
                self.nfa.eps[s].append(opt.start)
                frags.append(_Frag(s, opt.outs + [s]))
        if not frags:       # {0} / {0,0} degenerate: empty match
            s = self.nfa.new_state()
            return _Frag(s, [s])
        for a, b in zip(frags, frags[1:]):
            for o in a.outs:
                self.nfa.eps[o].append(b.start)
        return _Frag(frags[0].start, frags[-1].outs)

    def _atom(self) -> _Frag:
        if self.i >= len(self.p):
            raise GrammarError("unexpected end of regex")
        c = self.p[self.i]
        if c == "(":
            self.i += 1
            f = self._alt()
            if self.i >= len(self.p) or self.p[self.i] != ")":
                raise GrammarError("unclosed group")
            self.i += 1
            return f
        if c == "[":
            return self._charclass()
        if c == ".":
            self.i += 1
            return self._byte_frag(frozenset(range(256)) - {10, 13})
        if c == "\\":
            if self.i + 1 >= len(self.p):
                raise GrammarError("dangling backslash at end of regex")
            self.i += 2
            return self._byte_frag(_escape(self.p[self.i - 1]))
        if c in "*+?{":
            raise GrammarError(f"dangling quantifier at {self.i}")
        self.i += 1
        return self._bytes_frag(c.encode())

    def _charclass(self) -> _Frag:
        j = self.i + 1
        negate = j < len(self.p) and self.p[j] == "^"
        if negate:
            j += 1
        chars: set[int] = set()
        while j < len(self.p) and self.p[j] != "]":
            if self.p[j] == "\\":
                if j + 1 >= len(self.p):
                    raise GrammarError("dangling backslash in class")
                chars |= _escape(self.p[j + 1])
                j += 2
                continue
            if (j + 2 < len(self.p) and self.p[j + 1] == "-"
                    and self.p[j + 2] != "]"):
                chars |= set(range(ord(self.p[j]), ord(self.p[j + 2]) + 1))
                j += 3
                continue
            chars.add(ord(self.p[j]))
            j += 1
        if j >= len(self.p):
            raise GrammarError("unclosed character class")
        self.i = j + 1
        byte_set = frozenset(chars if not negate
                             else set(range(256)) - chars)
        return self._byte_frag(byte_set)

    def _byte_frag(self, byte_set: Iterable[int]) -> _Frag:
        a, b = self.nfa.new_state(), self.nfa.new_state()
        self.nfa.edges[a].append((frozenset(byte_set), b))
        return _Frag(a, [b])

    def _bytes_frag(self, bs: bytes) -> _Frag:
        """A literal (possibly multi-byte UTF-8) character."""
        start = self.nfa.new_state()
        cur = start
        for byte in bs:
            nxt = self.nfa.new_state()
            self.nfa.edges[cur].append((frozenset({byte}), nxt))
            cur = nxt
        return _Frag(start, [cur])


def _escape(c: str) -> frozenset:
    table = {
        "d": set(range(48, 58)),
        "w": set(range(48, 58)) | set(range(65, 91))
             | set(range(97, 123)) | {95},
        "s": {9, 10, 13, 32},
        "n": {10}, "t": {9}, "r": {13},
    }
    if c in table:
        return frozenset(table[c])
    if c == "D":
        return frozenset(set(range(256)) - set(range(48, 58)))
    if c == "S":
        return frozenset(set(range(256)) - {9, 10, 13, 32})
    return frozenset(c.encode())


# ---------------------------------------------------------------------------
# NFA → DFA (subset construction over bytes)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ByteDfa:
    """next[state][byte] (-1 = dead); accepting: bool per state."""

    next: np.ndarray          # (S, 256) int32
    accepting: np.ndarray     # (S,) bool


def compile_regex(pattern: str, deadline_s: float = 15.0) -> ByteDfa:
    """deadline_s bounds CPU for the whole compile: guided_regex is
    user-supplied via the API, and pathological (but state-cap-legal)
    patterns make subset construction + minimization superlinear — a
    wall-clock budget is the only bound that holds for every shape."""
    import time as _time

    t_end = _time.monotonic() + deadline_s
    nfa, start, accept = _RegexParser(pattern).parse()

    def closure(states: frozenset) -> frozenset:
        stack, seen = list(states), set(states)
        while stack:
            s = stack.pop()
            for t in nfa.eps[s]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    start_set = closure(frozenset({start}))
    ids = {start_set: 0}
    order = [start_set]
    rows: list[np.ndarray] = []
    i = 0
    while i < len(order):
        if i % 64 == 0 and _time.monotonic() > t_end:
            raise GrammarError(
                f"regex compile exceeded {deadline_s:.0f}s "
                f"(pattern too complex)")
        cur = order[i]
        i += 1
        row = np.full(256, DEAD, dtype=np.int32)
        # group target NFA-state sets per byte
        by_byte: dict[int, set] = {}
        for s in cur:
            for byte_set, t in nfa.edges[s]:
                for b in byte_set:
                    by_byte.setdefault(b, set()).add(t)
        cache: dict[frozenset, int] = {}
        for b, targets in by_byte.items():
            tgt = frozenset(targets)
            sid = cache.get(tgt)
            if sid is None:
                cl = closure(tgt)
                if cl not in ids:
                    if len(ids) >= MAX_DFA_STATES:
                        raise GrammarError(
                            f"grammar exceeds {MAX_DFA_STATES} DFA states")
                    ids[cl] = len(ids)
                    order.append(cl)
                sid = ids[cl]
                cache[tgt] = sid
            row[b] = sid
        rows.append(row)
    accepting = np.array([accept in s for s in order], dtype=bool)
    return minimize(ByteDfa(next=np.stack(rows), accepting=accepting),
                    t_end=t_end)


def minimize(dfa: ByteDfa, t_end: Optional[float] = None) -> ByteDfa:
    """Moore partition refinement. The bounded-depth JSON expansion
    produces heavily redundant states (each depth re-states the scalar
    grammar); minimization typically shrinks it several-fold, which
    directly shrinks the (S, V) device tables."""
    S = dfa.next.shape[0]
    # block id per state; dead (-1) maps to its own implicit block
    block = dfa.accepting.astype(np.int64).copy()
    import time as _time
    while True:
        if t_end is not None and _time.monotonic() > t_end:
            raise GrammarError("regex compile exceeded deadline during "
                               "minimization (pattern too complex)")
        # signature: (block, blocks of the 256 successors)
        succ_blocks = np.where(dfa.next >= 0,
                               block[np.clip(dfa.next, 0, S - 1)], -1)
        sig = np.concatenate([block[:, None], succ_blocks], axis=1)
        _, new_block = np.unique(sig, axis=0, return_inverse=True)
        if np.array_equal(new_block, block):
            break
        block = new_block
    n_blocks = int(block.max()) + 1
    # representative per block; new start = block of state 0, renumber so
    # the start block is 0
    order = np.full(n_blocks, -1, dtype=np.int64)
    start_b = block[0]
    perm = {start_b: 0}
    for s in range(S):
        b = int(block[s])
        if b not in perm:
            perm[b] = len(perm)
        if order[b] < 0:
            order[b] = s
    new_next = np.full((n_blocks, 256), DEAD, dtype=np.int32)
    new_acc = np.zeros(n_blocks, dtype=bool)
    for b in range(n_blocks):
        rep = int(order[b])
        nb = perm[b]
        row = dfa.next[rep]
        new_next[nb] = np.where(
            row >= 0, [perm[int(block[t])] for t in row.tolist()], DEAD)
        new_acc[nb] = dfa.accepting[rep]
    return ByteDfa(next=new_next, accepting=new_acc)


def match_bytes(dfa: ByteDfa, data: bytes) -> bool:
    s = 0
    for b in data:
        s = int(dfa.next[s, b])
        if s == DEAD:
            return False
    return bool(dfa.accepting[s])


# ---------------------------------------------------------------------------
# grammars
# ---------------------------------------------------------------------------


def choice_regex(choices: list[str]) -> str:
    """guided_choice: exact alternation of escaped literals."""
    if not choices:
        raise GrammarError("guided_choice requires at least one choice")

    def esc(s: str) -> str:
        return "".join("\\" + c if c in r"\.[]()*+?{}|^-" else c
                       for c in s)

    return "|".join(f"({esc(c)})" for c in choices)


_JSON_STR = r'"([^"\\]|\\["\\nrt])*"'
# leading zeros are not JSON ("00" must not parse)
_JSON_NUM = r"(-)?(0|[1-9]\d*)((\.)\d+)?(([eE])((\+)|(-))?\d+)?"


def json_regex(max_depth: int = 4) -> str:
    """Bounded-nesting JSON value grammar (the regular approximation of
    the context-free JSON grammar, same approach as outlines)."""
    ws = r"\s*"
    value = f"({_JSON_STR}|{_JSON_NUM}|true|false|null)"
    for _ in range(max_depth):
        arr = f"(\\[{ws}(({value}{ws}(,{ws}{value}{ws})*)?)\\])"
        obj = (f"(\\{{{ws}(({_JSON_STR}{ws}:{ws}{value}{ws}"
               f"(,{ws}{_JSON_STR}{ws}:{ws}{value}{ws})*)?)\\}})")
        value = f"({_JSON_STR}|{_JSON_NUM}|true|false|null|{arr}|{obj})"
    # NO trailing \s*: once the value completes, the only legal
    # continuation is EOS (a trailing-whitespace loop would let the
    # model pad to max_tokens instead of stopping)
    return f"{ws}{value}"


def json_schema_regex(schema, max_depth: int = 4) -> str:
    """guided_json with a schema object: a PRAGMATIC subset — type
    string/number/integer/boolean/object-with-properties/array-of/enum.
    Unknown constructs fall back to the free JSON value grammar."""
    import json as _json

    if isinstance(schema, str):
        schema = _json.loads(schema)
    if not isinstance(schema, dict):
        return json_regex(max_depth)
    ws = r"\s*"
    t = schema.get("type")
    if "enum" in schema:
        opts = []
        for v in schema["enum"]:
            opts.append(choice_regex([_json.dumps(v)]))
        return "|".join(f"({o})" for o in opts)
    if t == "string":
        return _JSON_STR
    if t == "integer":
        # match _JSON_NUM's integer part: leading zeros are invalid JSON
        return r"(-)?(0|[1-9]\d*)"
    if t == "number":
        return _JSON_NUM
    if t == "boolean":
        return "true|false"
    if t == "array":
        item = json_schema_regex(schema.get("items", {}),
                                 max_depth - 1) if max_depth > 0 \
            else json_regex(1)
        return f"\\[{ws}((({item}){ws}(,{ws}({item}){ws})*)?)\\]"
    if t == "object" and "properties" in schema and max_depth > 0:
        parts = []
        for key, sub in schema["properties"].items():
            kre = choice_regex([f'"{key}"'])
            vre = json_schema_regex(sub, max_depth - 1)
            parts.append(f"({kre}){ws}:{ws}({vre})")
        inner = f"{ws},{ws}".join(parts)
        return f"\\{{{ws}{inner}{ws}\\}}"
    return json_regex(max_depth)


# ---------------------------------------------------------------------------
# token-level tables
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GuidedTables:
    """Per-grammar device-uploadable tables over a tokenizer's vocab.

    EOS-AGNOSTIC: which token(s) terminate a sequence is a PER-REQUEST
    property (stop_token_ids), not a grammar property — the engine
    allows a lane's stop tokens wherever `eos_ok` holds, so one cached
    table serves requests with different stop tokens.

    allowed_bits: (S, ceil(V/8)) uint8 — token id t allowed in state s
      iff bit (t % 8) of allowed_bits[s, t // 8] (stop tokens excluded)
    next_state: (S, V) int16 — DFA state after emitting token t
    eos_ok: (S,) bool — stop tokens legal: accepting states, plus
      dead-end states (no continuation at all) where EOS is FORCED so
      generation terminates instead of sampling from -inf logits
    accepting: (S,) bool — the grammar is satisfied here
    """

    allowed_bits: np.ndarray
    next_state: np.ndarray
    eos_ok: np.ndarray
    accepting: np.ndarray

    @property
    def num_states(self) -> int:
        return self.next_state.shape[0]


def token_tables(dfa: ByteDfa,
                 token_bytes: list[Optional[bytes]]) -> GuidedTables:
    """Lift a byte DFA to token granularity.

    token_bytes[t] is the byte string token t contributes to the output
    (None/empty = special token, never allowed — termination is the
    engine's per-request stop-token overlay, see GuidedTables). For each
    (state, token): walk the token's bytes through the DFA; allowed iff
    it survives."""
    S = dfa.next.shape[0]
    V = len(token_bytes)
    if S > np.iinfo(np.int16).max:
        raise GrammarError("grammar too large for int16 state table")
    allowed = np.zeros((S, V), dtype=bool)
    nxt = np.zeros((S, V), dtype=np.int16)
    # walk each token once: vectorize over states by iterating token
    # bytes through the full per-state transition columns
    states0 = np.arange(S, dtype=np.int64)
    for t, bs in enumerate(token_bytes):
        if not bs:
            continue
        cur = states0
        alive = np.ones(S, dtype=bool)
        for b in bs:
            step = dfa.next[np.clip(cur, 0, S - 1), b]
            alive &= (cur >= 0) & (step >= 0)
            cur = step
        allowed[:, t] = alive
        nxt[:, t] = np.where(alive, cur, 0).astype(np.int16)
    dead = ~allowed.any(axis=1)
    eos_ok = dfa.accepting | dead
    pad = (-V) % 8
    if pad:
        allowed = np.concatenate(
            [allowed, np.zeros((S, pad), dtype=bool)], axis=1)
    bits = np.packbits(allowed.reshape(S, -1, 8), axis=-1,
                       bitorder="little")[:, :, 0]
    return GuidedTables(allowed_bits=bits, next_state=nxt,
                        eos_ok=eos_ok, accepting=dfa.accepting.copy())


def _gpt2_char_to_byte() -> dict[str, int]:
    """The standard byte-level-BPE printable remap (GPT-2/Llama-3 vocabs
    store raw bytes as mapped unicode chars, e.g. space → 'Ġ'),
    inverted: char → original byte."""
    bs = (list(range(33, 127)) + list(range(161, 173))
          + list(range(174, 256)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for c, b in zip(cs, bs)}


def token_bytes_of(tokenizer, vocab_size: int) -> list[Optional[bytes]]:
    """Per-token-id output bytes for a serving tokenizer.

    Exact for ByteTokenizer (id == byte). For HF tokenizers:
    - byte-level BPE vocabs (GPT-2/Llama-3 style, detected by 'Ġ'
      tokens) decode EXACTLY via the inverse printable remap — tokens
      carrying partial UTF-8 sequences keep their raw bytes (a decode()
      fallback would smear them into U+FFFD and desync the DFA from the
      actual output stream);
    - sentencepiece vocabs map '▁'→space and '<0xAB>' byte-fallback
      tokens to their byte; other tokens are valid unicode and encode
      directly.
    Special tokens map to None (never emitted under guidance)."""
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

    if isinstance(tokenizer, ByteTokenizer):
        out: list[Optional[bytes]] = [bytes([i]) for i in range(256)]
        out += [None] * max(0, vocab_size - 256)
        return out[:vocab_size]
    hf = getattr(tokenizer, "_tok", None)
    if hf is None:
        raise GrammarError(
            f"guided decoding unsupported for {type(tokenizer).__name__}")
    specials = set(hf.all_special_ids or [])
    toks = [hf.convert_ids_to_tokens(i) for i in range(vocab_size)]
    inv = _gpt2_char_to_byte()
    byte_level = any(isinstance(t, str) and ("Ġ" in t or "Ċ" in t)
                     for t in toks if t)
    out = []
    for i, t in enumerate(toks):
        if i in specials or t is None or not isinstance(t, str):
            out.append(None)
            continue
        if t.startswith("<0x") and t.endswith(">") and len(t) == 6:
            out.append(bytes([int(t[3:5], 16)]))      # byte fallback
        elif byte_level:
            try:
                out.append(bytes(inv[c] for c in t))
            except KeyError:
                out.append(None)    # added token outside the byte map
        elif "▁" in t:                             # sentencepiece ▁
            out.append(t.replace("▁", " ").encode())
        else:
            out.append(t.encode())
    return out


def compile_guided(spec: dict,
                   token_bytes: list[Optional[bytes]]) -> GuidedTables:
    """spec: one of {"regex": ...} / {"choice": [...]} / {"json": true |
    schema} (protocol surface mirrors GuidedDecodingOptions)."""
    if "regex" in spec:
        pattern = spec["regex"]
    elif "choice" in spec:
        pattern = choice_regex(list(spec["choice"]))
    elif "json" in spec:
        j = spec["json"]
        pattern = json_regex() if j in (True, None, {}) \
            else json_schema_regex(j)
    else:
        raise GrammarError(f"unknown guided spec {sorted(spec)}")
    return token_tables(compile_regex(pattern), token_bytes)
