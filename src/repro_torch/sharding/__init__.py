"""Sharding rules and DTensor placements (the port's ``repro.sharding``)."""
from repro_torch.sharding.rules import (  # noqa: F401
    MeshShape, batch_axes, param_pspecs, zero1_pspecs, activation_pspec,
    cache_pspecs, input_pspecs, placements, place, gather, shard_batch,
    use_mesh, current_mesh,
)
