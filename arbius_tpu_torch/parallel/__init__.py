"""Device-mesh parallelism for the port: a mesh of lanes in one process.

Twin of arbius_tpu/parallel/. A mesh (pp / dp / sp / tp axes) holds one
torch device per lane; a sharded program runs each lane's shard in lane
order and the collectives are ordered tensor operations over the lanes'
tensors (mesh.py, collectives.py). Axes:
  dp — data parallel: independent tasks over lanes (solutions/hour);
  tp — tensor parallel: kernels split over lanes;
  sp — sequence parallel: frames or tokens over lanes (ops/ring.py,
       ops/ulysses.py);
  pp — pipeline stages (parallel/pipeline.py is not ported: ROADMAP
       queue 1 item 11).
Left out until they are ported: `abstract_mesh` (graph tracing, item 12),
`DEFAULT_TP_RULES` (the families' tp layouts, item 11) and
`pipeline_apply` / `stack_stage_params` (pp, item 11).
"""
from arbius_tpu_torch.parallel.mesh import (
    Mesh,
    MeshSpec,
    build_mesh,
    lane_devices,
    local_mesh,
    mesh_tag,
    set_virtual_lanes,
    validate_axes,
    virtual_lanes,
)
from arbius_tpu_torch.parallel.sharding import (
    LaneSharding,
    Sharded,
    batch_sharding,
    replicated,
    shard_params,
    sharding_for,
    sharding_tree,
)
from arbius_tpu_torch.parallel.collectives import (
    all_gather_seq,
    all_to_all,
    halo_exchange,
    ppermute,
    psum,
    quantized_ring_allreduce,
    ring_pass,
)
from arbius_tpu_torch.parallel.distributed import initialize_distributed
from arbius_tpu_torch.parallel import meshsolve

__all__ = [
    "LaneSharding",
    "Mesh",
    "MeshSpec",
    "Sharded",
    "build_mesh",
    "lane_devices",
    "local_mesh",
    "mesh_tag",
    "meshsolve",
    "set_virtual_lanes",
    "validate_axes",
    "virtual_lanes",
    "batch_sharding",
    "replicated",
    "shard_params",
    "sharding_for",
    "sharding_tree",
    "all_gather_seq",
    "all_to_all",
    "halo_exchange",
    "ppermute",
    "psum",
    "quantized_ring_allreduce",
    "ring_pass",
    "initialize_distributed",
]
