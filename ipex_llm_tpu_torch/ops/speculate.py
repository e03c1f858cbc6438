"""The prompt-lookup draft proposer of the speculative tick (port of
``ipex_llm_tpu/ops/speculate.py``).

:func:`propose_ngram_rows` scans each row's device-resident token history
with tensor operations only, so the speculative horizon loop drafts with no
host n-gram table, no draft upload and no read-back.  Per row it computes
exactly what the host proposer (``serving/engine.py::_propose_ngram``)
computes: the longest n-gram first, the most recent earlier occurrence
wins, the continuation is clipped at the history end.  The emitted streams
never depend on the drafts (acceptance only emits tokens sampled from the
true conditionals); keeping the two proposers identical keeps the accept
counts of the fused tick and of the host-walk engine comparable.
"""

from __future__ import annotations

import torch


def propose_ngram_rows(hist: torch.Tensor, lens: torch.Tensor, k: int,
                       ngram: int):
    """Prompt-lookup draft candidates for a batch of rows.

    ``hist`` [R, S] int32 token history per row (prompt and emitted tokens,
    zero-padded); ``lens`` [R] the valid history length per row (the
    current token sits at ``hist[r, lens[r] - 1]``).  For each row, find the
    most recent earlier occurrence of the trailing n-gram (longest
    ``n <= ngram`` first) and propose the ``k`` tokens that followed it.

    Returns ``(drafts [R, k] int32, n_prop [R] int32)``: ``drafts[r, j]`` is
    valid for ``j < n_prop[r]`` and zero beyond, and ``n_prop`` counts the
    proposed run, ``min(k, continuation length)``, 0 when no n-gram of any
    length matches.  A row whose history is too short for a 1-gram match
    (``lens < 2``) proposes nothing.
    """
    r, s = hist.shape
    dev = hist.device
    lens = lens.to(torch.int64)
    idx = torch.arange(s, device=dev)
    found = torch.zeros((r,), dtype=torch.bool, device=dev)
    best_start = torch.zeros((r,), dtype=torch.int64, device=dev)
    for n in range(ngram, 0, -1):
        # trailing n-gram per row: hist[r, lens[r]-n : lens[r]]
        tpos = lens[:, None] - n + torch.arange(n, device=dev)[None, :]
        tail = torch.gather(hist, 1, tpos.clamp(0, s - 1))
        # m[r, s0] == (hist[r, s0:s0+n] == tail[r]) via shifted compares;
        # the roll's wraparound only touches s0 > S - n, which the validity
        # bound below excludes (s0 < lens - n <= S - n)
        m = torch.ones((r, s), dtype=torch.bool, device=dev)
        for j in range(n):
            m &= torch.roll(hist, -j, dims=1) == tail[:, j:j + 1]
        # a previous occurrence wholly before the tail window, and only for
        # rows whose history admits an n-gram (the host bound n <= lens-1)
        valid = (m & (idx[None, :] < (lens - n)[:, None])
                 & ((lens - 1) >= n)[:, None])
        any_m = valid.any(dim=1)
        start = torch.where(valid, idx[None, :],
                            torch.full_like(valid, -1, dtype=torch.int64)
                            ).amax(dim=1) + n
        take = any_m & ~found                 # the longest n wins
        best_start = torch.where(take, start, best_start)
        found |= any_m
    cpos = best_start[:, None] + torch.arange(k, device=dev)[None, :]
    cand = torch.gather(hist, 1, cpos.clamp(0, s - 1))
    # the continuation is clipped at the history end
    n_prop = torch.where(found, (lens - best_start).clamp(0, k),
                         torch.zeros_like(lens))
    drafts = torch.where(torch.arange(k, device=dev)[None, :]
                         < n_prop[:, None], cand, torch.zeros_like(cand))
    return drafts.to(torch.int32), n_prop.to(torch.int32)
