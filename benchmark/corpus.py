"""Seeded Silesia-like objects, made with whole-array NumPy operations.

The same five content classes as the port's `tpz_torch/utils/corpus.py`
(`mixed`: pseudo-English text, C-like source, repetitive runs, uniform
random bytes, Zipf-skewed bytes), concatenated in that order at the
shares a configuration file names. That module appends a word at a time
in a Python loop (about 25 s of one core for 16 MiB); this one draws each
class's tokens or segments in bulk and gathers their bytes in one
indexing pass, so an object of 16 MiB takes well under a second. The
bytes are not those of the port's copy: what is kept is each class's
generating rule and share, and that the same seed gives the same bytes.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_WORDS = (
    "the of and a to in is was he for it with as his on be at by i this had "
    "not are but from or have an they which one you were her all she there "
    "would their we him been has when who will more no if out so said what "
    "up its about into than them can only other new some could time these "
    "two may then do first any my now such like our over man me even most "
    "made after also did many before must through back years where much "
    "your way well down should because each just those people mr how too "
    "little state good very make world still own see men work long get "
    "here between both life being under never day same another know while "
    "last might us great old year off come since against go came right "
    "used take three states himself few house use during without again "
    "place american around however home small found mrs thought went say "
    "part once general high upon school every don does got united left "
    "number course war until always away something fact though water less "
    "public put think almost hand enough far took head yet government "
    "system better set told nothing night end why called didn eyes find "
    "going look asked later knew point next city business"
).split()
LINE = 71  # a text line breaks after the word that passes this many bytes


def _draw(rng: np.random.Generator, weights: np.ndarray, n: int):
    """n indices into `weights`, each drawn with its weight's share."""
    cdf = np.cumsum(weights / weights.sum())
    return np.minimum(np.searchsorted(cdf, rng.random(n), side="right"),
                      len(weights) - 1)


class _Table:
    """Byte strings laid end to end, to be gathered by id."""

    def __init__(self, pieces: list[bytes]):
        self.lens = np.array([len(p) for p in pieces], np.int64)
        self.offs = np.concatenate([[0], np.cumsum(self.lens)[:-1]])
        self.flat = np.frombuffer(b"".join(pieces), np.uint8)

    def gather(self, ids: np.ndarray) -> np.ndarray:
        lens = self.lens[ids]
        ends = np.cumsum(lens)
        idx = np.repeat(self.offs[ids] - (ends - lens), lens)
        idx += np.arange(idx.size)
        return self.flat[idx]


def _text_table() -> _Table:
    """Id word * 8 + capital * 4 + period * 2 + newline."""
    pieces = []
    for w in _WORDS:
        for cap in (w, w.capitalize()):
            for dot in ("", "."):
                for sep in (" ", "\n"):
                    pieces.append((cap + dot + sep).encode())
    return _Table(pieces)


_TEXT = _text_table()
_FNS = [f"process_block_{i}" for i in range(40)]
_VARS = ["count", "offset", "length", "state", "buffer", "index", "result"]
_SRC_LIT = ["static int ", "(uint8_t *", ", size_t ",
            ") {\n    size_t i = 0;\n    for (; i < ", "; ++i) {\n        ",
            "[i] = (", "[i] + ", ") & 0xff;\n    }\n    return (int)i;\n}\n\n"]
_SOURCE = _Table([s.encode() for s in _SRC_LIT + _FNS + _VARS]
                 + [str(k).encode() for k in range(4096)])


def text(n: int, rng: np.random.Generator) -> bytes:
    """Pseudo-English: words drawn with Zipf-like frequencies (1 / rank),
    4% capitalised, 8% followed by a period, lines of about 71 bytes."""
    rank = np.arange(1, len(_WORDS) + 1)
    out, have = [np.empty(0, np.uint8)], 0
    while have < n:
        k = (n - have) // 4 + 64
        word = _draw(rng, 1.0 / rank, k)
        cap = rng.random(k) < 0.04
        dot = rng.random(k) < 0.08
        col = np.cumsum(_TEXT.lens[word * 8])
        nl = np.diff(col // LINE, prepend=0) > 0
        part = _TEXT.gather(word * 8 + cap * 4 + dot * 2 + nl)
        out.append(part)
        have += part.size
    return np.concatenate(out)[:n].tobytes()


def source_code(n: int, rng: np.random.Generator) -> bytes:
    """C-like functions from one template: a name of 40, two variables of
    7 and a constant below 4,096 drawn for each."""
    out, have = [np.empty(0, np.uint8)], 0
    nlit, nfn, nvar = len(_SRC_LIT), len(_FNS), len(_VARS)
    while have < n:
        k = (n - have) // 150 + 8
        fn = nlit + rng.integers(nfn, size=k)
        v1 = nlit + nfn + rng.integers(nvar, size=k)
        v2 = nlit + nfn + rng.integers(nvar, size=k)
        const = nlit + nfn + nvar + rng.integers(4096, size=k)
        lit = [np.full(k, i) for i in range(nlit)]
        ids = np.stack([lit[0], fn, lit[1], v1, lit[2], v2, lit[3], v2,
                        lit[4], v1, lit[5], v1, lit[6], const, lit[7]], 1)
        part = _SOURCE.gather(ids.reshape(-1))
        out.append(part)
        have += part.size
    return np.concatenate(out)[:n].tobytes()


def repetitive(n: int, rng: np.random.Generator) -> bytes:
    """Segments of three kinds, drawn alike: a byte run of 4-599, a
    pattern of 2-8 random bytes repeated 2-119 times, or 1-39 random
    bytes."""
    out, have = [np.empty(0, np.uint8)], 0
    while have < n:
        k = (n - have) // 150 + 8
        kind = rng.integers(3, size=k)
        run = rng.integers(4, 600, size=k)
        plen = rng.integers(2, 9, size=k)
        reps = rng.integers(2, 120, size=k)
        rlen = rng.integers(1, 40, size=k)
        pat = rng.integers(0, 256, size=(k, 8), dtype=np.uint8)
        seglen = np.where(kind == 0, run, np.where(kind == 1, plen * reps,
                                                   rlen))
        ends = np.cumsum(seglen)
        seg = np.repeat(np.arange(k), seglen)
        off = np.arange(seg.size) - (ends - seglen)[seg]
        rnd = rng.integers(0, 256, size=seg.size, dtype=np.uint8)
        ks = kind[seg]
        part = np.where(ks == 0, pat[seg, 0],
                        np.where(ks == 1, pat[seg, off % plen[seg]], rnd))
        out.append(part.astype(np.uint8))
        have += part.size
    return np.concatenate(out)[:n].tobytes()


def random_bytes(n: int, rng: np.random.Generator) -> bytes:
    """Incompressible uniform-random bytes."""
    return rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()


def skewed_bytes(n: int, rng: np.random.Generator) -> bytes:
    """Bytes with a Zipf(1.5) histogram cut at 256 values (byte b drawn
    with weight (b + 1) ** -1.5, as Zipf draws above 256 thrown away give
    it): Huffman-friendly, LZ-hostile."""
    return _draw(rng, np.arange(1, 257) ** -1.5, n).astype(np.uint8).tobytes()


CLASSES = {"text": text, "source": source_code, "repetitive": repetitive,
           "random": random_bytes, "skewed": skewed_bytes}


def mixed(n: int, rng: np.random.Generator, shares, fill: str) -> bytes:
    """The classes of `shares` ([name, d] pairs: n // d bytes of class
    `name`) in their order, then class `fill` up to n bytes."""
    parts = [CLASSES[name](n // d, rng) for name, d in shares]
    rest = n - sum(len(p) for p in parts)
    if rest > 0:
        parts.append(CLASSES[fill](rest, rng))
    return b"".join(parts)[:n]


def pool(seed: int, count: int, nbytes: int, content: dict) -> list[bytes]:
    """`count` objects of `nbytes` bytes, object j drawn from the seed
    sequence (seed, j): the same seed gives the same bytes, whatever the
    count. NumPy's bulk draws and gathers release the interpreter lock,
    so the objects are made in threads."""

    def one(j):
        return mixed(nbytes, np.random.default_rng([seed % 2**64, j]),
                     content["shares"], content["fill"])

    with ThreadPoolExecutor(min(count, os.cpu_count() or 1)) as ex:
        return list(ex.map(one, range(count)))
