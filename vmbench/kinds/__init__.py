"""One module a kind of configuration: a config file's ``kind`` names the
module ``vmbench.kinds.<kind>`` (a lower-case identifier), which
``run.run_cell`` imports. A cell of a new kind arrives as new files (this
module, its configuration, its mix, any reader of its own) and new entries
in ``BENCHMARK.json``; no file of the harness changes. The module holds:

- ``Program``, a class. ``Program(config, mix, seed, device)`` is the
  set-up: it makes the pool of inputs from the seed and builds the
  program's state. ``morph(item, spans)`` runs one morph of the pool's
  ``item`` through the program's public entries, each layer's call inside
  ``with spans(name)``, and returns ``{"frames", "counts", "outputs"[,
  "phases"]}``: the frames it made, its counts for the readers, what
  ``check`` compares, and the walls of the program's own phases.
  ``span_names``, a tuple of strings, lists the host ranges its traced
  morphs open. ``release()`` frees the program's state.
- ``check(config, mix, seed, device, item, outputs)``, a function, which
  makes the item's inputs again, computes them with the plain reference and
  returns each number compared under its name in the configuration's
  ``limits``.
"""
