"""The port's guided-decoding grammar compiler (dynamo_tpu_torch/llm/guided.py)
and OpenAI request surface (`protocols_openai._guided_from`) against the
JAX package's, on the same inputs.

Tables: `compile_guided` of every spec — regexes from tests/test_guided.py,
a choice, JSON mode and JSON schemas — over two vocabularies (the byte
tokenizer's, and a byte-level BPE vocabulary read through an in-process
stand-in for an HF tokenizer, as tests/test_guided.py builds one) must give
byte-identical `allowed_bits`, `next_state`, `eos_ok` and `accepting`. The
same bad grammars raise `GrammarError` in both, and the same request
bodies give the same guided spec or the same 400.
"""

import numpy as np
import pytest

from dynamo_tpu.llm import guided as jg
from dynamo_tpu.llm import protocols_openai as jp
from dynamo_tpu.llm.tokenizer import ByteTokenizer as JaxByteTokenizer
from dynamo_tpu_torch.llm import guided as tg
from dynamo_tpu_torch.llm import protocols_openai as tp
from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

SPECS = {
    "alt-digits": {"regex": r"(abc|a\d+)x?"},
    "class-escapes": {"regex": r"[a-c]+\s[^0-9]"},
    "date": {"regex": r"\d{4}-\d{2}-\d{2}"},
    "bounded": {"regex": r"a{2,4}"},
    "open-bound": {"regex": r"(ab){2,}"},
    "stacked": {"regex": r"a*{2}"},
    "zero-rep": {"regex": r"x(ab){0,0}y"},
    "words": {"regex": r"[a-z]+( [a-z]+){0,7}\."},
    "choice": {"choice": ["a+b", "c.d", "yes"]},
    "json-mode": {"json": True},
    "json-schema": {"json": {
        "type": "object",
        "properties": {"name": {"type": "string"},
                       "age": {"type": "integer"},
                       "tags": {"type": "array",
                                "items": {"enum": ["x", "y"]}},
                       "ok": {"type": "boolean"}}}},
    "json-number": {"json": {"type": "number"}},
}


def _gpt2_bytes_to_char():
    return {b: c for c, b in jg._gpt2_char_to_byte().items()}


class _FakeHf:
    """What `token_bytes_of` reads of an HF tokenizer: special ids and
    `convert_ids_to_tokens`. A byte-level BPE vocabulary: specials, every
    byte as its printable stand-in, then merges (words with the 'Ġ'
    space, a two-byte UTF-8 character, JSON punctuation) and one added
    token outside the byte map."""

    all_special_ids = [0, 1]

    def __init__(self):
        b2c = _gpt2_bytes_to_char()
        merges = [b" hello", b"ab", b" a", b'{"', b'":', b'",', b"12",
                  b"true", b"\xc3\xa9", b"\n", b" the", b"x."]
        self._vocab = (["<s>", "</s>"] + [b2c[b] for b in range(256)]
                       + ["".join(b2c[b] for b in m) for m in merges]
                       + ["<|日本|>"])

    def convert_ids_to_tokens(self, i):
        return self._vocab[i]


class _FakeTok:
    def __init__(self):
        self._tok = _FakeHf()


VOCABS = {
    "byte": lambda mod, tok_cls: mod.token_bytes_of(tok_cls(), 300),
    "bpe": lambda mod, tok_cls: mod.token_bytes_of(
        _FakeTok(), len(_FakeHf()._vocab)),
}


@pytest.fixture(scope="module")
def vocab_bytes():
    out = {}
    for name, make in VOCABS.items():
        want = make(jg, JaxByteTokenizer)
        got = make(tg, ByteTokenizer)
        assert got == want
        out[name] = got
    return out


def test_token_bytes_of_both_branches(vocab_bytes):
    byte, bpe = vocab_bytes["byte"], vocab_bytes["bpe"]
    assert byte[:256] == [bytes([i]) for i in range(256)]
    assert byte[256:] == [None] * 44
    assert bpe[0] is None and bpe[1] is None             # specials
    assert bpe[2 + 0x20] == b" " and bpe[2 + 256] == b" hello"
    assert b"\xc3\xa9" in bpe                             # raw UTF-8 kept
    assert bpe[-1] is None                                # outside the map
    with pytest.raises(tg.GrammarError):
        tg.token_bytes_of(object(), 10)


@pytest.mark.parametrize("vocab", sorted(VOCABS))
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_compile_guided_tables_identical(vocab_bytes, spec, vocab):
    tb = vocab_bytes[vocab]
    want = jg.compile_guided(SPECS[spec], tb)
    got = tg.compile_guided(SPECS[spec], tb)
    for f in ("allowed_bits", "next_state", "eos_ok", "accepting"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert np.array_equal(a, b), f
    assert got.num_states == want.num_states
    assert got.allowed_bits.shape[1] == (len(tb) + 7) // 8


# JSON mode's byte DFA is held through its tables above (~10 s a compile)
@pytest.mark.parametrize("spec", sorted(set(SPECS) - {"json-mode"}))
def test_byte_dfa_identical(spec):
    s = SPECS[spec]
    if "regex" in s:
        pattern = (s["regex"],) * 2
    elif "choice" in s:
        pattern = (tg.choice_regex(s["choice"]), jg.choice_regex(s["choice"]))
    else:
        pattern = (tg.json_schema_regex(s["json"]),
                   jg.json_schema_regex(s["json"]))
    assert pattern[0] == pattern[1]
    got, want = tg.compile_regex(pattern[0]), jg.compile_regex(pattern[1])
    assert np.array_equal(got.next, want.next)
    assert np.array_equal(got.accepting, want.accepting)
    for text in (b"abcx", b"a12", b"2024-01-31", b"aaa", b"ababab", b"xy",
                 b"hello world.", b"c.d", b'{"name": "x", "age": 3}',
                 b"-1.5e3", b"", b"zz"):
        assert tg.match_bytes(got, text) == jg.match_bytes(want, text)


BAD_GRAMMARS = [
    ("regex", "(unclosed"), ("regex", "abc\\"), ("regex", "[ab\\"),
    ("regex", "[abc"), ("regex", "*a"), ("regex", "a{3,2}"),
    ("regex", "a{2"), ("regex", "a{x}"), ("regex", "a{300}"),
    ("regex", "a{256}{256}"), ("regex", "a)"), ("choice", []),
    ("nope", 1),
]


@pytest.mark.parametrize("kind,arg", BAD_GRAMMARS,
                         ids=[f"{k}-{a!r}" for k, a in BAD_GRAMMARS])
def test_same_grammar_errors(kind, arg):
    tb = [bytes([i]) for i in range(256)]
    with pytest.raises(jg.GrammarError) as want:
        jg.compile_guided({kind: arg}, tb)
    with pytest.raises(tg.GrammarError) as got:
        tg.compile_guided({kind: arg}, tb)
    assert str(got.value) == str(want.value)
    assert issubclass(tg.GrammarError, ValueError)


BODIES = {
    "none": {},
    "json-object": {"response_format": {"type": "json_object"}},
    "json-schema": {"response_format": {
        "type": "json_schema",
        "json_schema": {"name": "x", "schema": {"type": "integer"}}}},
    "json-schema-bare": {"response_format": {"type": "json_schema"}},
    "text-format": {"response_format": {"type": "text"}},
    "nvext-regex": {"nvext": {"guided_regex": "[a-z]+"}},
    "nvext-choice": {"nvext": {"guided_choice": ["yes", "no"]}},
    "nvext-json": {"nvext": {"guided_json": {"type": "boolean"}}},
    "top-regex": {"guided_regex": "a|b"},
    "two-sources": {"guided_regex": "a", "nvext": {"guided_choice": ["b"]}},
    "grammar": {"nvext": {"guided_grammar": "root ::= x"}},
    "bad-schema": {"response_format": {"type": "json_schema",
                                       "json_schema": "nope"}},
}


@pytest.mark.parametrize("body", sorted(BODIES))
@pytest.mark.parametrize("kind", ["chat", "completion"])
def test_guided_from_matches_reference(body, kind):
    d = {"model": "m", **BODIES[body]}
    if kind == "chat":
        d["messages"] = [{"role": "user", "content": "hi"}]
        ours, ref = tp.ChatCompletionRequest, jp.ChatCompletionRequest
    else:
        d["prompt"] = "hi"
        ours, ref = tp.CompletionRequest, jp.CompletionRequest
    try:
        want = ref.from_dict(dict(d))
    except jp.OpenAIError as e:
        with pytest.raises(tp.OpenAIError) as got:
            ours.from_dict(dict(d))
        assert str(got.value) == str(e) and got.value.status == e.status
        return
    got = ours.from_dict(dict(d))
    nvext = d.get("nvext") or {}
    assert tp._guided_from(d, nvext) == jp._guided_from(d, nvext)
    assert got.guided == want.guided
    assert got.sampling_options().to_dict() == \
        want.sampling_options().to_dict()
