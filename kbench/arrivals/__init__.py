"""Arrival laws, one module each, found by the mix's ``arrivals.law``
(``traffic.law``). An open law sets ``OPEN = True`` and defines
``gaps(spec, n, rng)``: ``n`` gaps between arrivals with a mean of one
(the harness divides them by the cell's rate). A closed law sets
``OPEN = False`` and defines ``target(spec, slots)``: the waiting requests
the harness keeps in the queue."""
