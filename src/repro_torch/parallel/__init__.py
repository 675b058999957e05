"""Distribution of the port: logical-axis sharding rules for DP / FSDP /
TP / EP / SP, expressed as `DeviceMesh` placements."""
from .sharding import (LOGICAL_RULES, NamedSharding, PartitionSpec,
                       batch_spec, constrain, named_sharding,
                       set_active_mesh, spec_for, tree_shardings)
