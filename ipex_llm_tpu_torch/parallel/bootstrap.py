"""Joining the tensor-parallel group, and its health probe (port of
``ipex_llm_tpu/parallel/bootstrap.py``).

The reference calls ``jax.distributed.initialize``; the port joins a
``torch.distributed`` group instead (``parallel/mesh.py``), from the
reference's environment variables (``IPEX_LLM_TPU_NUM_PROCESSES``,
``IPEX_LLM_TPU_PROCESS_ID``, ``IPEX_LLM_TPU_COORDINATOR`` as
``host:port``) or, where they are unset, from torch's own (``WORLD_SIZE``,
``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``, as ``torchrun`` sets them).
"""

from __future__ import annotations

import os


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *,
                     backend: str = "nccl", device=None,
                     timeout_s: float | None = None,
                     collective_qtype: str | None = None):
    """Join the group this process belongs to; returns its ``TPGroup``, or
    None on a single process (nothing to join)."""
    from ipex_llm_tpu_torch.parallel.mesh import (DEFAULT_TIMEOUT_S,
                                                  init_tp_group)

    env = os.environ
    if num_processes is None:
        num_processes = int(env.get("IPEX_LLM_TPU_NUM_PROCESSES")
                            or env.get("WORLD_SIZE") or 0)
    if num_processes <= 1:
        return None
    if process_id is None:
        process_id = int(env.get("IPEX_LLM_TPU_PROCESS_ID")
                         or env.get("RANK") or 0)
    coordinator = coordinator or env.get("IPEX_LLM_TPU_COORDINATOR")
    init_method = f"tcp://{coordinator}" if coordinator else "env://"
    return init_tp_group(
        num_processes, process_id, backend=backend, device=device,
        init_method=init_method,
        timeout_s=DEFAULT_TIMEOUT_S if timeout_s is None else timeout_s,
        collective_qtype=collective_qtype)


def health(group) -> dict:
    """Group liveness: one tiny all-reduce of ones over the data group."""
    import torch

    from ipex_llm_tpu_torch.ops.collectives import all_reduce

    try:
        dev = group.device if group.backend == "nccl" else torch.device("cpu")
        total = all_reduce(torch.ones((1,), device=dev), group)
        ok = int(total.item()) == group.size
    except Exception as e:  # noqa: BLE001 -- a dead rank raises here
        return {"ok": False, "error": f"{type(e).__name__}: {e}",
                "n_ranks": group.size}
    return {"ok": ok, "n_ranks": group.size, "rank": group.rank,
            "backend": group.backend}
