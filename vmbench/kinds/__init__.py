"""One module a kind of configuration (a config file's ``kind``).

A module holds ``Program(config, mix, seed, device)``, whose
``morph(item, spans)`` runs one morph of the pool's ``item`` through the
program's public entries and returns ``{"frames", "counts", "outputs"[,
"phases"]}``, whose ``span_names`` lists the host ranges its traced morphs
open, and whose ``release()`` frees the program's state; and
``check(config, mix, seed, device, item, outputs)``, which makes the item's
inputs again, computes them with the plain reference and returns each
number compared under its name.
"""
