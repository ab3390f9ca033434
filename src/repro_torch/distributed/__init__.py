"""Distribution pieces of the port (``repro/distributed``): logical-axis
sharding rules on DTensor, parameter and cache specs, int8 gradient
compression, and fault tolerance."""
