"""Length laws, one module each, found by the ``law`` of a mix's
``prompt`` or ``output`` (``traffic.law``). Each defines
``draw(spec, n, rng)``: ``n`` lengths in tokens, which the generator puts
in the mix's order."""
