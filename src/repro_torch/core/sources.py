"""The seeded text corpus that serving prompts are cut from — the port's
own copy of ``repro.core.sources.corpus_documents`` (same words, same
random stream, so the same seed gives the same documents)."""
from __future__ import annotations

import random
from typing import Iterator

_WORDS = (
    "market stream data global news flash flood election satellite launch "
    "storm rally protest economy vaccine energy grid transit health summit "
    "quarter earnings merger strike wildfire quake rescue policy senate "
    "court ruling trade port cargo drought harvest festival derby final "
    "transfer record champion orbit probe lander relay fiber outage patch "
    "breach audit ledger token chain index fund bond yield rate cut hike"
).split()


def _sentence(rng: random.Random, n: int) -> str:
    return " ".join(rng.choices(_WORDS, k=n))


def corpus_documents(n_docs: int, seed: int = 7) -> Iterator[str]:
    """Deterministic text corpus."""
    rng = random.Random(seed)
    for _ in range(n_docs):
        yield _sentence(rng, rng.randint(30, 300))
