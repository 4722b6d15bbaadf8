"""repro_torch.dist: logical-axis sharding (passive on one device)."""

from .sharding import DEFAULT_RULES, LocalMesh, active_mesh, axis_rules, constrain, logical_spec

__all__ = ["DEFAULT_RULES", "LocalMesh", "active_mesh", "axis_rules", "constrain", "logical_spec"]
