"""Stand the system under test up from a configuration file.

The program's public classes, composed as ``launch/serve.py``'s
``paper_models_system`` composes them, but from the configuration
file's sizes and at the benchmark's scale: ``CFedRAGSystem`` over the
benchmark's corpus (one provider a site, each embedding its chunks with
F_emb into an index on the card), the F_aggr cross encoder as the
reranker, and the paged ``ServeEngine`` with the generator behind
``engine_generator``.

Weights are made here, on the card, from the seed: one buffer per model
filled by a few ``normal_`` calls of a CUDA generator, and each leaf a
view of it scaled by its initialiser's spread (``N(0, 1/fan_in)`` or
``N(0, scale^2)``, ones for the norms), in the program's parameter
layout.  The program is handed these tensors, and after the window the
reference reads the same ones.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pipeline import CFedRAGConfig, CFedRAGSystem
from repro_torch.data.corpus import Chunk, FederatedCorpus
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.models import cross_encoder as CE
from repro_torch.models import dual_encoder as DE
from repro_torch.models import lm as LM
from repro_torch.models.params import leaves
from repro_torch.serving.engine import ServeConfig, ServeEngine, engine_generator

from fedbench.traffic import Corpus, torch_seed

_FILL = 1 << 30  # elements per normal_ call


def model_config(m: dict) -> ModelConfig:
    """The program's ``ModelConfig`` from a configuration file's ``model`` block."""
    return ModelConfig(**m)


def make_weights(specs, seed: int, device) -> dict:
    """Every leaf of ``specs`` from one seeded buffer on ``device``."""
    flat_specs = leaves(specs)
    drawn = [(p, s) for p, s in flat_specs if s.init in ("normal", "fan_in")]
    total = sum(math.prod(s.shape) for _, s in drawn)
    gen = torch.Generator(device=device).manual_seed(seed)
    buf = torch.empty(total, dtype=torch.float32, device=device)
    for i in range(0, total, _FILL):
        buf[i : i + _FILL].normal_(generator=gen)
    out: dict = {}
    off = 0
    for path, s in flat_specs:
        if s.init in ("normal", "fan_in"):
            n = math.prod(s.shape)
            if s.init == "fan_in":
                fan = math.prod(s.shape[d] for d in (s.fan_in_dims or range(len(s.shape) - 1)))
                std = 1.0 / math.sqrt(max(fan, 1))
            else:
                std = s.scale
            leaf = buf[off : off + n].view(s.shape).mul_(std)
            off += n
        elif s.init == "ones":
            leaf = torch.ones(s.shape, dtype=torch.float32, device=device)
        else:
            leaf = torch.zeros(s.shape, dtype=torch.float32, device=device)
        *parents, last = path.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out


@dataclasses.dataclass
class Built:
    system: CFedRAGSystem
    engine: ServeEngine
    weights: dict  # "generator" / "embedder" / "reranker" -> nested dict of tensors
    models: dict  # the same keys -> the configuration file's model blocks


def federated_corpus(corpus: Corpus) -> FederatedCorpus:
    chunks = [
        Chunk(text, sub, int(site), i, -1)
        for i, (text, sub, site) in enumerate(zip(corpus.texts.strings, corpus.sub, corpus.site))
    ]
    return FederatedCorpus(chunks=chunks, queries=[])


def build(cfg: dict, corpus: Corpus, seed: int, device: str = "cuda", serve_overrides: dict | None = None) -> Built:
    """The configuration ``cfg`` (a configuration file) as the program runs it."""
    models = {k: cfg[k]["model"] for k in ("generator", "embedder", "reranker")}
    e_cfg, r_cfg, g_cfg = (model_config(models[k]) for k in ("embedder", "reranker", "generator"))
    weights = {
        "embedder": make_weights(DE.param_specs(e_cfg), torch_seed(seed, "embedder"), device),
        "reranker": make_weights(CE.param_specs(r_cfg), torch_seed(seed, "reranker"), device),
        "generator": make_weights(LM.param_specs(g_cfg), torch_seed(seed, "generator"), device),
    }
    tok = HashTokenizer(vocab_size=cfg["tokenizer_vocab_size"])  # one tokenizer feeds all three models
    e_params = weights["embedder"]

    def embed_fn(tokens):
        return DE.encode(e_cfg, e_params, torch.as_tensor(np.asarray(tokens), device=device))

    scfg = ServeConfig(**{**cfg["serve"], **(serve_overrides or {})})
    engine = ServeEngine(g_cfg, weights["generator"], scfg, device=device)
    r = cfg["retrieval"]
    system = CFedRAGSystem(
        federated_corpus(corpus),
        CFedRAGConfig(m_local=r["m_local"], n_global=r["n_global"], chunk_max_len=r["chunk_max_len"],
                      aggregation="rerank", split_by="site", device=device),
        tokenizer=tok, embed_fn=embed_fn, reranker=CE.make_reranker(r_cfg, weights["reranker"]),
        generator=engine_generator(engine),
    )
    return Built(system, engine, weights, models)
