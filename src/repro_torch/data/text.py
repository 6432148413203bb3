"""Offline text substrate: a synthetic English-like corpus (text8 analog:
lowercase a-z + space, vocab 27), a char tokenizer, and an offline
refinement oracle substituting the paper's Gemma3-27B rewriter.
(a numpy copy of the JAX package's ``data/text.py``)

The corpus is generated from a fixed word inventory with Zipfian unigram
frequencies and bigram transition structure — enough statistical signal
for the LSTM draft / DFM / proxy-LM comparisons of the paper's §4.2 to be
meaningful, fully offline and license-free.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

CHARS = " abcdefghijklmnopqrstuvwxyz"
VOCAB = len(CHARS)   # 27, exactly text8's alphabet
_C2I = {c: i for i, c in enumerate(CHARS)}

_WORDS = (
    "the of and to in a is that it was for on are as with his they at be this "
    "have from or had by word but not what all were we when your can said there "
    "use an each which she do how their if will up other about out many then "
    "them these so some her would make like him into time has look two more "
    "write go see number no way could people my than first water been call who "
    "oil its now find long down day did get come made may part over new sound "
    "take only little work know place year live me back give most very after "
    "thing our just name good sentence man think say great where help through "
    "much before line right too mean old any same tell boy follow came want "
    "show also around form three small set put end does another well large "
    "must big even such because turn here why ask went men read need land "
    "different home us move try kind hand picture again change off play spell "
    "air away animal house point page letter mother answer found study still "
    "learn should america world history science model train language system"
).split()


def _transition_matrix(num_words: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    # Zipf unigram prior mixed with sparse bigram affinities
    zipf = 1.0 / np.arange(1, num_words + 1) ** 1.1
    zipf /= zipf.sum()
    trans = np.tile(zipf, (num_words, 1))
    hot = rng.integers(0, num_words, size=(num_words, 8))
    for i in range(num_words):
        trans[i, hot[i]] += 0.08
    trans /= trans.sum(-1, keepdims=True)
    return trans


@dataclasses.dataclass
class SyntheticCorpus:
    seed: int = 0
    num_words: int = 0

    def __post_init__(self):
        self.words = list(_WORDS)
        self.num_words = len(self.words)
        self.trans = _transition_matrix(self.num_words, self.seed)
        zipf = 1.0 / np.arange(1, self.num_words + 1) ** 1.1
        self.unigram = zipf / zipf.sum()

    def generate_text(self, num_chars: int, rng: np.random.Generator) -> str:
        out: List[str] = []
        total = 0
        w = int(rng.choice(self.num_words, p=self.unigram))
        while total < num_chars:
            word = self.words[w]
            out.append(word)
            total += len(word) + 1
            w = int(rng.choice(self.num_words, p=self.trans[w]))
        return " ".join(out)[:num_chars]

    def sequences(self, num: int, seq_len: int, seed: int = 1) -> np.ndarray:
        rng = np.random.default_rng(seed)
        text = self.generate_text(num * seq_len + seq_len, rng)
        enc = encode(text)
        starts = rng.integers(0, len(enc) - seq_len, size=num)
        return np.stack([enc[s : s + seq_len] for s in starts]).astype(np.int32)


def encode(text: str) -> np.ndarray:
    return np.array([_C2I.get(c, 0) for c in text.lower()], np.int32)


def decode(tokens) -> str:
    return "".join(CHARS[int(t) % VOCAB] for t in tokens)


# ---------------------------------------------------------------------------
# Offline refinement oracle (stands in for the paper's LLM rewriter):
# re-segment the draft into dictionary words by greedy nearest-word
# matching, preserving length and local content — the same contract as the
# paper's prompt ("more natural ... not too different from the input").
# ---------------------------------------------------------------------------

class WordOracle:
    def __init__(self, corpus: SyntheticCorpus):
        self.corpus = corpus
        self.by_len: dict = {}
        for w in corpus.words:
            self.by_len.setdefault(len(w), []).append(w)
        self.maxlen = max(self.by_len)

    def _nearest_word(self, frag: str) -> str:
        cands = self.by_len.get(len(frag))
        if not cands:
            for d in range(1, self.maxlen):
                cands = self.by_len.get(len(frag) - d) or self.by_len.get(len(frag) + d)
                if cands:
                    break
        best, score = cands[0], -1
        for w in cands:
            s = sum(a == b for a, b in zip(frag, w))
            if s > score:
                best, score = w, s
        return best

    def refine_text(self, text: str) -> str:
        frags = text.split()
        words = [self._nearest_word(f) if f else "" for f in frags]
        out = " ".join(w for w in words if w)
        return (out + " " + out)[: len(text)] if len(out) < len(text) else out[: len(text)]

    def __call__(self, drafts: np.ndarray) -> np.ndarray:
        """(B, N) tokens -> (B, N) refined tokens (length-preserving)."""
        out = np.empty_like(drafts)
        for i in range(drafts.shape[0]):
            refined = self.refine_text(decode(drafts[i]))
            enc = encode(refined)
            if len(enc) < drafts.shape[1]:
                enc = np.pad(enc, (0, drafts.shape[1] - len(enc)))
            out[i] = enc[: drafts.shape[1]]
        return out


# ---------------------------------------------------------------------------
# Proxy evaluation LM (GPT-J stand-in): a char n-gram model fitted on
# held-out data provides NLL and next-token entropy for generated samples.
# ---------------------------------------------------------------------------

class NGramProxyLM:
    def __init__(self, order: int = 3, smoothing: float = 0.1):
        self.order = order
        self.smoothing = smoothing
        self.counts: Optional[np.ndarray] = None

    def fit(self, sequences: np.ndarray) -> "NGramProxyLM":
        o = self.order
        counts = np.full((VOCAB,) * o, self.smoothing, np.float64)
        for seq in sequences:
            for i in range(len(seq) - o + 1):
                counts[tuple(seq[i : i + o])] += 1.0
        self.counts = counts
        self.probs = counts / counts.sum(-1, keepdims=True)
        return self

    def nll(self, sequences: np.ndarray) -> float:
        o = self.order
        tot, n = 0.0, 0
        for seq in sequences:
            for i in range(len(seq) - o + 1):
                tot -= np.log(self.probs[tuple(seq[i : i + o])])
                n += 1
        return tot / max(n, 1)

    def entropy(self, sequences: np.ndarray) -> float:
        o = self.order
        tot, n = 0.0, 0
        for seq in sequences:
            for i in range(len(seq) - o + 1):
                ctx = tuple(seq[i : i + o - 1])
                p = self.probs[ctx]
                tot += -np.sum(p * np.log(np.maximum(p, 1e-12)))
                n += 1
        return tot / max(n, 1)
