"""Prompt laws, one module each, found by the mix's ``tokens.law``
(``traffic.law``; default ``distinct``). Each defines
``tokens(spec, seed, i, n, vocab)``: request i's prompt tokens, from the
run's seed, for a drawn prompt length ``n``."""
