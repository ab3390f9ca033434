"""Distribution pieces of the port (``repro/distributed``): the step monitor."""
