"""Deterministic synthetic test corpus (the port's copy of
tpz/utils/corpus.py; the tests hold both to the same bytes), and
`make_corpus`, which makes many `mixed` buffers in parallel processes.

The real Canterbury/Silesia corpora are not available in this offline
environment (SURVEY.md §6 protocol), so tests and benchmarks use seeded
synthetic files spanning the same content classes: natural-language-like
text, structured markup, source code, repetitive runs, and incompressible
random data. All generation is seeded — every call reproduces identical
bytes, so golden files derived from them are stable.
"""

from __future__ import annotations

import functools
import multiprocessing
import os

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


@functools.lru_cache(maxsize=None)
def text(n: int, seed: int = 0) -> bytes:
    """Pseudo-English text with Zipf-like word frequencies."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    ranks = np.arange(1, len(_WORDS) + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    line_len = 0
    while len(out) < n:
        w = _WORDS[rng.choice(len(_WORDS), p=probs)]
        if rng.random() < 0.04:
            w = w.capitalize()
        out += w.encode()
        line_len += len(w) + 1
        if rng.random() < 0.08:
            out += b"."
        if line_len > 70:
            out += b"\n"
            line_len = 0
        else:
            out += b" "
    return bytes(out[:n])


@functools.lru_cache(maxsize=None)
def source_code(n: int, seed: int = 1) -> bytes:
    """C-like source code: highly structured, long-range repetition."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    fns = [f"process_block_{i}" for i in range(40)]
    vars_ = ["count", "offset", "length", "state", "buffer", "index", "result"]
    while len(out) < n:
        fn = fns[rng.integers(len(fns))]
        v1, v2 = (vars_[rng.integers(len(vars_))] for _ in range(2))
        k = int(rng.integers(0, 4096))
        out += (
            f"static int {fn}(uint8_t *{v1}, size_t {v2}) {{\n"
            f"    size_t i = 0;\n"
            f"    for (; i < {v2}; ++i) {{\n"
            f"        {v1}[i] = ({v1}[i] + {k}) & 0xff;\n"
            f"    }}\n"
            f"    return (int)i;\n"
            f"}}\n\n"
        ).encode()
    return bytes(out[:n])


@functools.lru_cache(maxsize=None)
def repetitive(n: int, seed: int = 2) -> bytes:
    """Long runs and short periodic patterns (LZ-friendly extremes)."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    while len(out) < n:
        kind = rng.integers(3)
        if kind == 0:
            out += bytes([int(rng.integers(256))]) * int(rng.integers(4, 600))
        elif kind == 1:
            pat = bytes(rng.integers(0, 256, size=int(rng.integers(2, 9)), dtype=np.uint8))
            out += pat * int(rng.integers(2, 120))
        else:
            out += bytes(rng.integers(0, 256, size=int(rng.integers(1, 40)), dtype=np.uint8))
    return bytes(out[:n])


@functools.lru_cache(maxsize=None)
def random_bytes(n: int, seed: int = 3) -> bytes:
    """Incompressible uniform-random bytes."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()


@functools.lru_cache(maxsize=None)
def skewed_bytes(n: int, seed: int = 4) -> bytes:
    """Random bytes with a heavily skewed histogram (Huffman-friendly,
    LZ-hostile)."""
    rng = np.random.default_rng(seed)
    vals = rng.zipf(1.5, size=2 * n)
    vals = vals[vals <= 256][:n] - 1
    if vals.size < n:
        vals = np.pad(vals, (0, n - vals.size))
    return vals.astype(np.uint8).tobytes()


def mixed(n: int, seed: int = 5) -> bytes:
    """Silesia-like mix of all content classes."""
    parts = [
        text(n // 3, seed),
        source_code(n // 4, seed + 1),
        repetitive(n // 6, seed + 2),
        random_bytes(n // 8, seed + 3),
        skewed_bytes(n // 8, seed + 4),
    ]
    blob = b"".join(parts)
    if len(blob) < n:
        blob += text(n - len(blob), seed + 6)
    return blob[:n]


def _mixed(spec):
    n, seed = spec
    return mixed(n, seed=seed)


def make_corpus(specs) -> list[bytes]:
    """mixed buffers for (size, seed) pairs. A 16 MiB buffer takes ~25 s
    of one core, so they are made in parallel processes, one per 4 MiB of
    corpus and at most one a core; under 4 MiB in all they are made here,
    as a worker's start (~2 s of imports) would cost more."""
    procs = min(len(specs), os.cpu_count() or 1,
                -(-sum(n for n, _ in specs) // (4 << 20)))
    if procs <= 1:
        return [_mixed(spec) for spec in specs]
    with multiprocessing.get_context("spawn").Pool(procs) as pool:
        return pool.map(_mixed, specs)


#: Small adversarial inputs every codec must handle (SURVEY.md §4 item 1).
def edge_cases() -> dict[str, bytes]:
    return {
        "empty": b"",
        "one_byte": b"A",
        "two_bytes": b"ab",
        "all_zero_1k": b"\x00" * 1024,
        "all_ff_300": b"\xff" * 300,
        "min_match_run": b"abcabcabcabc",
        "max_match_run": b"x" * 300,
        "alternating": b"ab" * 200,
        "single_then_random": b"q" * 100 + random_bytes(100, 9),
        "ascending": bytes(range(256)) * 4,
        "window_boundary": random_bytes(100, 10) + b"\x00" * 33000 + random_bytes(100, 10),
        "text_4k": text(4096),
        "random_4k": random_bytes(4096),
        "repetitive_4k": repetitive(4096),
    }


def standard_suite(size: int = 1 << 16) -> dict[str, bytes]:
    """Named mid-size files for round-trip/interop tests."""
    return {
        "text": text(size),
        "source": source_code(size),
        "repetitive": repetitive(size),
        "random": random_bytes(size),
        "skewed": skewed_bytes(size),
        "mixed": mixed(size),
    }
