"""Chunked vocabulary cross-entropy: never materializes [B*S, V] logits.

Port of ``deepspeed_tpu/ops/cross_entropy.py``: row chunks of 512, each
chunk's logits -> logsumexp -> gold logit -> masked NLL in fp32 under
``torch.utils.checkpoint``, so the backward recomputes a chunk's logits
instead of saving them. Peak memory is O(chunk * V).
"""

import torch
from torch.utils.checkpoint import checkpoint


def _chunk_nll(hc, yc, kernel, bias, ignore_index):
    logits = torch.matmul(hc, kernel).float()
    if bias is not None:
        logits = logits + bias.float()
    lse = torch.logsumexp(logits, dim=-1)
    valid = yc != ignore_index
    gold = torch.gather(logits, 1, torch.where(valid, yc, 0)[:, None])[:, 0]
    nll = torch.where(valid, lse - gold, 0.0)
    return nll.sum(), valid.sum()


def chunked_cross_entropy(hidden, kernel, bias, labels, ignore_index=-1,
                          rows_per_chunk=512):
    """Mean NLL of ``softmax(hidden @ kernel + bias)`` against ``labels``.

    ``hidden`` [..., H]; ``kernel`` [H, V]; ``bias`` [V] or None;
    ``labels`` [...] int, ``ignore_index`` entries contribute 0. Per row
    the NLL is logsumexp(logits) - logits[gold], both in fp32."""
    H = hidden.shape[-1]
    h = hidden.reshape(-1, H)
    y = labels.reshape(-1).long()
    rows = max(1, min(rows_per_chunk, h.shape[0]))
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.int64, device=h.device)
    for start in range(0, h.shape[0], rows):
        s, c = checkpoint(_chunk_nll, h[start:start + rows], y[start:start + rows],
                          kernel, bias, ignore_index, use_reentrant=False,
                          preserve_rng_state=False)
        total = total + s
        count = count + c
    return total / torch.clamp(count, min=1)
