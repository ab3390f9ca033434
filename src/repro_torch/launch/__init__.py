"""Launch tooling of the port (``repro/launch``): the production mesh, the
per-cell rules, specs and fake-tensor setups, the dry run of every cell on a
fake process group, the per-device step analysis and H100 roofline, the
collective profile and the report."""
