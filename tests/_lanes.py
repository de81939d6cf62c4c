"""Packed paged steps for the tests: the port's ``mixed_step`` /
``verify_step`` take a step's live tokens back to back (``lm.Lanes``);
the reference takes a (B, W) token grid with per-row ``(q_start,
q_len)``.  ``packed`` turns the second into the first."""
import numpy as np
import torch

from repro_torch.models import lm as TLM


def packed(tok, q_start, q_len, tables, block_size, n_read=None, device="cpu"):
    """Row ``b`` carries ``tok[b, :q_len[b]]`` from ``q_start[b]``; its last
    ``n_read[b]`` lanes are read (every live lane by default).  Returns the
    packed tokens (N,), the ``lm.Lanes`` on ``device`` and the (row, lane)
    of the grid that each read comes from, for indexing the reference's
    (B, W, V) logits."""
    q_len = np.asarray(q_len, np.int64)
    n_read = q_len if n_read is None else np.asarray(n_read, np.int64)
    host = TLM.pack_lanes(q_start, q_len, n_read, np.asarray(tables), block_size)
    rows = np.repeat(np.arange(len(q_len)), q_len)
    lanes = TLM.ragged(np.zeros_like(q_len), q_len)
    reads = host["reads"]
    tokens = torch.as_tensor(np.asarray(tok)[rows, lanes], dtype=torch.int32, device=device)
    on = TLM.Lanes(*(torch.as_tensor(host[f], device=device) for f in TLM.Lanes._fields))
    return tokens, on, (rows[reads], lanes[reads])


def pack_rows(q, desc):
    """A padded kernel call (q (R, W, H, dh), desc (R, 4); numpy or torch)
    as the packed one: the rows' live lanes back to back, desc (R, 5) with
    each row's lane offset ``q_off``, and the (row, lane) of the padded q
    that each packed lane comes from."""
    d = np.asarray(desc.cpu() if torch.is_tensor(desc) else desc)
    q_len = d[:, 2].astype(np.int64)
    off = np.cumsum(q_len) - q_len
    rows = np.repeat(np.arange(len(d)), q_len)
    lanes = TLM.ragged(np.zeros_like(q_len), q_len)
    d5 = np.concatenate([d, off[:, None]], axis=1).astype(np.int32)
    if torch.is_tensor(q):
        at = (torch.as_tensor(rows, device=q.device), torch.as_tensor(lanes, device=q.device))
        return q[at].contiguous(), torch.as_tensor(d5, device=q.device), rows, lanes
    return q[rows, lanes], d5, rows, lanes
