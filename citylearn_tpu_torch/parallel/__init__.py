from citylearn_tpu_torch.parallel.mesh import (  # noqa: F401
    DistrictMesh,
    all_gather,
    all_reduce,
    broadcast,
    district_mesh,
    district_slice,
    free_port,
    gather_districts,
    initialize_distributed,
    shard_district_batch,
)
