"""Launch tooling of the port (``repro/launch``): the production mesh and the
per-cell sharding rules and input specs."""
