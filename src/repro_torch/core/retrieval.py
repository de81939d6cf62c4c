"""In-mesh federated retrieval: Alg. 1 steps 2-4 when providers are mesh
shards.

The corpus is split over the mesh's provider axis; each shard runs the
local maximum-inner-product top-k (``kernels/retrieval_topk``: the kernel
on the card, its plain version on the CPU) on its slice, and only the
``(score, global id, provider)`` candidate tuples, ``m_local`` per query
and provider and never a raw chunk, cross the shard boundary, gathered
onto the lead device in provider order and merged there: the paper's
"providers return m candidates, the orchestrator merges" flow.  An
``alive`` quorum mask sets a failed or straggling provider's scores to
``-inf`` before the merge, so serving degrades gracefully.

The merge keeps ``lax.top_k``'s order: score descending, ties to the
lower index of the provider-major candidate list (a stable descending
sort; ``torch.topk`` does not promise that order).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.retrieval_topk.ops import retrieval_topk
from repro_torch.runtime.compat import Mesh, gather, split


def local_topk(q_emb, corpus_shard, m: int):
    """One provider's top-``m``: (scores (Q, m) f32, local ids (Q, m) i32)."""
    return retrieval_topk(q_emb, corpus_shard, m)


def federated_topk(q_emb, corpus, m_local: int, n_global: int, mesh: Mesh | None = None,
                   provider_axis: str = "data", alive=None):
    """q_emb (Q, D); corpus (N, D) split over the provider axis (or the
    list of its per-provider slices, each on its shard's device).  Returns
    (scores (Q, n_global) f32, global ids (Q, n_global) i32, providers
    (Q, n_global) i32) on the lead device; global id = local id + pid *
    n_loc.  ``alive`` (n_providers,) bool: a dead provider's candidates
    score ``-inf``.  Without a mesh (or one without ``provider_axis``) the
    whole corpus is one provider."""
    if mesh is None or provider_axis not in mesh.shape:
        s, i = local_topk(q_emb, corpus, n_global)
        return s, i, torch.zeros_like(i)
    slices = split(corpus, mesh, 0)
    n_prov, n_loc = mesh.size, slices[0].shape[0]
    if n_global > n_prov * m_local:
        raise ValueError(f"federated_topk: n_global={n_global} > {n_prov} providers x m_local={m_local}")
    lead = mesh.lead
    alive = torch.ones(n_prov, dtype=torch.bool) if alive is None else torch.as_tensor(alive, dtype=torch.bool)
    cand_s, cand_g, cand_p = [], [], []
    for pid, dev in enumerate(mesh.devices):
        s, i = local_topk(q_emb.to(dev), slices[pid], m_local)  # (Q, m) local ids
        s = torch.where(alive[pid].to(dev), s, torch.full_like(s, -torch.inf))  # straggler / failure mask
        cand_s.append(s)
        cand_g.append(i + pid * n_loc)
        cand_p.append(torch.full_like(i, pid))
    q_n = q_emb.shape[0]
    # only (score, id, provider) tuples cross the provider boundary, in provider order
    s_flat = torch.stack(gather(cand_s, lead), dim=1).reshape(q_n, -1)  # (Q, P * m)
    g_flat = torch.stack(gather(cand_g, lead), dim=1).reshape(q_n, -1)
    p_flat = torch.stack(gather(cand_p, lead), dim=1).reshape(q_n, -1)
    top_s, pos = torch.sort(s_flat, dim=1, descending=True, stable=True)
    pos = pos[:, :n_global]
    return (top_s[:, :n_global].contiguous(), torch.gather(g_flat, 1, pos).to(torch.int32),
            torch.gather(p_flat, 1, pos).to(torch.int32))


# the reference jit-compiles federated_topk under this name; eager PyTorch
# has nothing to compile, so it is the same function
federated_topk_jit = federated_topk
