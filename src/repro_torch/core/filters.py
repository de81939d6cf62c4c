"""NVFlare-style task data / result filters (paper §2.3.1 "Data Privacy").

Filters are composable transforms applied to payloads on both ends of a
channel: the provider filters what leaves its boundary; the orchestrator
filters what enters the enclave.  Each filter sees a payload dict and
returns a (possibly modified) payload dict.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

Payload = dict


class Filter:
    name = "filter"

    def __call__(self, payload: Payload) -> Payload:  # pragma: no cover
        raise NotImplementedError


@dataclasses.dataclass
class MaxChunksFilter(Filter):
    """Cap how many chunks a provider will ever return (policy control)."""

    max_chunks: int
    name = "max_chunks"

    def __call__(self, payload: Payload) -> Payload:
        if "chunk_tokens" in payload:
            payload = dict(payload)
            # truncate the candidate axis: last-but-one for (.., m, S)
            # chunk tokens, last for (.., m) scores/ids — works for both
            # single-query and (B, ...) batched payloads
            payload["chunk_tokens"] = payload["chunk_tokens"][..., : self.max_chunks, :]
            for k in ("scores", "chunk_ids"):
                if k in payload:
                    payload[k] = payload[k][..., : self.max_chunks]
        return payload


@dataclasses.dataclass
class ScoreQuantizeFilter(Filter):
    """Coarsen scores before they leave the provider (reduces what a curious
    orchestrator can infer about the local corpus distribution)."""

    decimals: int = 2
    name = "score_quantize"

    def __call__(self, payload: Payload) -> Payload:
        if "scores" in payload:
            payload = dict(payload)
            payload["scores"] = np.round(payload["scores"], self.decimals)
        return payload


@dataclasses.dataclass
class DPNoiseFilter(Filter):
    """Gaussian-mechanism noise on embedding payloads (paper §4.3 mentions
    differential privacy as a candidate PET for federated embedding flows)."""

    sigma: float = 0.01
    seed: int = 0
    name = "dp_noise"

    def __call__(self, payload: Payload) -> Payload:
        if "embeddings" in payload:
            payload = dict(payload)
            rng = np.random.default_rng(self.seed)
            e = payload["embeddings"]
            payload["embeddings"] = e + rng.normal(0, self.sigma, e.shape).astype(e.dtype)
        return payload


@dataclasses.dataclass
class ProvenanceStripFilter(Filter):
    """Remove provider-internal identifiers before chunks leave the site."""

    keep: tuple = ("chunk_tokens", "scores", "chunk_ids", "provider")
    name = "provenance_strip"

    def __call__(self, payload: Payload) -> Payload:
        return {k: v for k, v in payload.items() if k in self.keep}


def apply_filters(filters: list[Filter], payload: Payload) -> Payload:
    for f in filters:
        payload = f(payload)
    return payload
