"""Distribution layer: the ``[E, s, p]`` expert stack every fit objective
sums over, and its split over the ranks of a process group (``mesh.py``,
``distributed.py``)."""

from spark_gp_tpu_torch.parallel.experts import ExpertData, group_for_experts
from spark_gp_tpu_torch.parallel.mesh import (
    EXPERT_AXIS,
    ExpertMesh,
    expert_mesh,
    shard_experts,
)

__all__ = ["ExpertData", "group_for_experts", "EXPERT_AXIS", "ExpertMesh", "expert_mesh",
           "shard_experts"]
