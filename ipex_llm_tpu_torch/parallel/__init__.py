"""Tensor parallelism over ``torch.distributed`` (port of
``ipex_llm_tpu/parallel/``): one process a rank, the rank's group passed
down explicitly (``mesh.TPGroup``), its slices of the params
(``manual.shard_params_manual``) and of the paged pool
(``shard.shard_paged_cache``).  Pipeline, data, expert and context
parallelism are not ported (ROADMAP item 15)."""

from ipex_llm_tpu_torch.parallel.mesh import MeshSpec, TPGroup, init_tp_group

__all__ = ["MeshSpec", "TPGroup", "init_tp_group"]
