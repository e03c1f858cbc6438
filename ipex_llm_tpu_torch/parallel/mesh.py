"""The tensor-parallel group (port of ``ipex_llm_tpu/parallel/mesh.py``).

The reference builds one JAX mesh over its chips; the port runs one
process per rank of a ``torch.distributed`` group instead, and passes the
group down explicitly (:class:`TPGroup`).  :class:`MeshSpec` keeps the
reference's axes, but only ``tp`` is served: data, pipeline, expert and
context parallelism raise (ROADMAP item 15).

Backends: ``"nccl"`` when every rank has its own card (rank r on
``cuda:r``), the default.  ``"gloo"`` only when the caller names it: it
runs any number of ranks on one card, or on the CPU, with its collectives
through the host.  Asking for nccl with more ranks than cards raises; it
is never swapped for gloo.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass

import torch

AXES = ("dp", "pp", "tp", "ep", "cp")
BACKENDS = ("nccl", "gloo")
DEFAULT_TIMEOUT_S = 300.0
# joining: the ranks may start far apart (process start, imports)
RENDEZVOUS_S = 300.0


@dataclass(frozen=True)
class MeshSpec:
    """The reference's mesh axes; only ``tp`` may exceed 1 in the port."""
    dp: int = 1
    tp: int = 1
    ep: int = 1
    cp: int = 1
    pp: int = 1

    def __post_init__(self):
        others = {a: n for a, n in self.axis_sizes().items()
                  if a != "tp" and n > 1}
        if others:
            raise NotImplementedError(
                f"mesh axes {others} are not ported: the port serves tensor "
                "parallelism only (ROADMAP item 15)")
        if self.tp < 1:
            raise ValueError("tp must be >= 1")

    @property
    def size(self) -> int:
        return self.dp * self.tp * self.ep * self.cp * self.pp

    def axis_sizes(self) -> dict[str, int]:
        return {"dp": self.dp, "pp": self.pp, "tp": self.tp, "ep": self.ep,
                "cp": self.cp}


@dataclass(frozen=True)
class TPGroup:
    """One rank's view of its tensor-parallel group: ``pg`` carries the
    tensor collectives (``ops/collectives.py``), ``ctrl`` (always gloo,
    CPU tensors) the engine's lockstep messages; both with ``timeout_s``.
    ``collective_qtype`` is the all-reduce's wire family."""
    rank: int
    size: int
    backend: str
    device: torch.device
    pg: object
    ctrl: object
    timeout_s: float
    collective_qtype: str = "bf16"

    @property
    def leader(self) -> bool:
        return self.rank == 0


def rank_device(backend: str, rank: int, size: int, device=None
                ) -> torch.device:
    """The card (or CPU) rank ``rank`` runs on.  nccl: ``cuda:rank``, one
    card a rank; a device naming another card, or fewer cards than ranks,
    raises.  gloo: ``device`` (default ``cuda:0``) for every rank."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if backend == "gloo":
        return torch.device(device if device is not None else "cuda:0")
    want = torch.device("cuda", rank)
    dev = torch.device(device) if device is not None else want
    n_cards = torch.cuda.device_count()
    if dev.type != "cuda" or n_cards < size or dev != want:
        raise ValueError(
            f"nccl needs one card a rank: {size} ranks, {n_cards} CUDA "
            f"card(s), rank {rank} asked for {dev}; two ranks on one card "
            "(or on the CPU) run only under backend='gloo', named by the "
            "caller")
    return dev


def init_tp_group(size: int, rank: int, *, backend: str = "nccl",
                  device=None, init_method: str | None = None, store=None,
                  timeout_s: float = DEFAULT_TIMEOUT_S,
                  collective_qtype: str | None = None) -> TPGroup:
    """Join the default process group as ``rank`` of ``size`` (through
    ``init_method``, a ``tcp://host:port`` or ``file://`` URL, or a
    ``torch.distributed`` ``store``; waiting up to ``RENDEZVOUS_S`` for
    the others) and build the rank's :class:`TPGroup`: the data group on
    ``backend`` and a gloo control group, both with ``timeout_s``."""
    import torch.distributed as dist

    from ipex_llm_tpu_torch.ops.collectives import resolve_qtype

    dev = rank_device(backend, rank, size, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=timeout_s)
    kw = dict(backend=backend, world_size=size, rank=rank,
              timeout=datetime.timedelta(seconds=max(timeout_s,
                                                     RENDEZVOUS_S)))
    if store is not None:
        kw["store"] = store
    else:
        kw["init_method"] = init_method or "env://"
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(**kw)
    pg = dist.new_group(backend=backend, timeout=timeout)
    ctrl = dist.new_group(backend="gloo", timeout=timeout)
    return TPGroup(rank=rank, size=size, backend=backend, device=dev,
                   pg=pg, ctrl=ctrl, timeout_s=timeout_s,
                   collective_qtype=resolve_qtype(collective_qtype))


def destroy_tp_group():
    """Leave the default process group (and with it every group of it)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
