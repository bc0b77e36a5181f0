"""Zipf word text: a vocabulary of 32,768 words of 2-10 letters a-z,
drawn with exponent 1.1, each word followed by one of ``" "``, ``", "``,
``". "`` or ``"\\n"`` (uniformly).  The vocabulary and the exponent are
chosen: no text corpus is in the repository.  The vocabulary is the
same for every seed (drawn from ``VOCABULARY_SEED``), so every seed's
text compresses alike and a seed changes which words come, not how much
work they are.  Copied from the program's earlier bench
(``bench_torch/corpora.py``, ``words_text``), which drew the vocabulary
from the seed."""

import numpy as np

VOCABULARY_SEED = 1


def make(n: int, rng: np.random.Generator) -> np.ndarray:
    n_vocab = 32768
    vocab = np.random.default_rng(VOCABULARY_SEED)
    lens = vocab.integers(2, 11, n_vocab)
    letters = vocab.integers(ord("a"), ord("z") + 1, int(lens.sum()),
                             dtype=np.uint8)
    seps = (b" ", b", ", b". ", b"\n")
    flat = np.concatenate([letters,
                           np.frombuffer(b"".join(seps), np.uint8)])
    tok_len = np.concatenate([lens, [len(s) for s in seps]])
    tok_start = np.cumsum(tok_len) - tok_len
    weight = 1.0 / np.arange(1, n_vocab + 1) ** 1.1
    cdf = np.cumsum(weight) / weight.sum()
    mean = (weight / weight.sum() * lens).sum() + 1.5
    k = int(n / mean * 1.05) + 64
    seq = np.empty(2 * k, np.int64)
    seq[0::2] = np.minimum(np.searchsorted(cdf, rng.random(k)), n_vocab - 1)
    seq[1::2] = n_vocab + rng.integers(0, len(seps), k)
    out_len = tok_len[seq]
    total = int(out_len.sum())
    if total < n:
        raise RuntimeError("word corpus came out short")
    out_start = np.cumsum(out_len) - out_len
    idx = np.repeat(tok_start[seq] - out_start, out_len) + np.arange(total)
    return flat[idx[:n]]
