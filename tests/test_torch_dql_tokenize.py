"""The port's DQL lexer against the reference's: its string token is
unrolled (runs of plain characters between escapes), so a long literal,
such as the 768 floats of a `similar_to` vector, lexes without a
backtracking frame a character. The tokens, their kinds and positions,
and the texts that fail to lex must be the reference's."""

import json
import random

import numpy as np
import pytest

from dgraph_tpu.dql import parser as ref_parser
from dgraph_tpu_torch.dql import parser as port_parser

VEC = json.dumps(np.random.default_rng(7).standard_normal(768).astype(np.float64).tolist())

CASES = [
    '{ q(func: similar_to(emb, 10, "%s")) { uid id } }' % VEC,
    '{ q(func: eq(name, "a \\"quoted\\" name")) { uid } }',
    '{ q(func: eq(name, "ends in a backslash \\\\")) { uid } }',
    '{ q(func: eq(name, "line\none")) { uid } }',
    '{ q(func: regexp(name, /^a\\/b.*$/i)) { uid } }',
    '{ q(func: eq(name, "unterminated)) { uid } }',
    '{ q(func: eq(name, "escape at the end \\',
    '"',
    '""',
    '"\\"',
    '{ q(func: eq(name, "")) { uid } } # "a comment"',
]


def _lex(mod, text):
    try:
        return [(t.kind, t.text, t.pos) for t in mod.tokenize(text)]
    except mod.ParseError as e:
        return ("error", str(e))


@pytest.mark.parametrize("text", CASES, ids=range(len(CASES)))
def test_tokens_equal_the_reference(text):
    assert _lex(port_parser, text) == _lex(ref_parser, text)


@pytest.mark.parametrize("seed", range(4))
def test_random_texts_lex_as_the_reference(seed):
    """Texts drawn from the characters that open, escape and close a
    string, a regex and a comment, among names and punctuation."""
    rng = random.Random(seed)
    alphabet = ['"', "\\", "a", "1", " ", "\n", "/", "#", "(", ")", ",", "{", "}", "."]
    for _ in range(400):
        text = "".join(rng.choice(alphabet) for _ in range(rng.randint(0, 40)))
        assert _lex(port_parser, text) == _lex(ref_parser, text), repr(text)


def test_long_vector_literal_is_one_string_token():
    toks = port_parser.tokenize('similar_to(emb, 10, "%s")' % (VEC * 64))
    strings = [t for t in toks if t.kind == "string"]
    assert len(strings) == 1 and strings[0].text == '"%s"' % (VEC * 64)
