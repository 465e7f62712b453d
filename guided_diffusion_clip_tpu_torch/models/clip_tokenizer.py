"""CLIP's byte-pair-encoding tokenizer (for text-target CLIP guidance).

The port's own copy of ``guided_diffusion_clip_tpu/models/clip_tokenizer.py``
(pure Python, no torch): the same ids, the same ``bpe_path`` /
``$CLIP_BPE_PATH`` rule and the same error when no vocabulary is found.

It implements the simple BPE scheme CLIP uses: lowercase + whitespace-cleaned
text, a regex over words/numbers, byte-to-unicode mapping, and greedy merges
with an end-of-word marker "</w>". The vocab/merges file
(bpe_simple_vocab_16e6.txt.gz, shipped with OpenAI CLIP) must be provided:
nothing is downloaded; point CLIP_BPE_PATH at it or pass ``bpe_path``.

Encoded sequences are wrapped as <|startoftext|> ... <|endoftext|> and padded
to the context length, matching what the precomputed embedding dicts were
built with.
"""

from __future__ import annotations

import gzip
import html
import os
import re
from functools import lru_cache


@lru_cache()
def bytes_to_unicode():
    """Reversible byte->unicode map avoiding control/whitespace chars (GPT-2/CLIP)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class SimpleTokenizer:
    def __init__(self, bpe_path: str | None = None, context_length: int = 77):
        bpe_path = bpe_path or os.environ.get("CLIP_BPE_PATH")
        if not bpe_path or not os.path.exists(bpe_path):
            raise FileNotFoundError(
                "CLIP BPE vocab not found; set CLIP_BPE_PATH to "
                "bpe_simple_vocab_16e6.txt.gz (no network egress here)"
            )
        self.context_length = context_length
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges if m]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {t: i for i, t in enumerate(vocab)}
        self.decoder = {i: t for t, i in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        # CLIP's word pattern uses \p{L}/\p{N} via the `regex` package; the
        # ASCII classes below are equivalent for English prompts (stdlib re).
        self.pat = re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
            re.IGNORECASE,
        )

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        bpe_tokens: list[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens

    def decode(self, tokens) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        return (
            bytearray(self.byte_decoder[c] for c in text)
            .decode("utf-8", errors="replace")
            .replace("</w>", " ")
        )

    def __call__(self, texts, truncate: bool = True):
        """Tokenize a str or list of strs -> int32 [N, context_length]."""
        import numpy as np

        if isinstance(texts, str):
            texts = [texts]
        sot = self.encoder["<|startoftext|>"]
        eot = self.encoder["<|endoftext|>"]
        out = np.zeros((len(texts), self.context_length), np.int32)
        for i, text in enumerate(texts):
            toks = [sot] + self.encode(text) + [eot]
            if len(toks) > self.context_length:
                if not truncate:
                    raise ValueError(f"text too long for context: {text!r}")
                toks = toks[: self.context_length - 1] + [eot]
            out[i, : len(toks)] = toks
        return out
