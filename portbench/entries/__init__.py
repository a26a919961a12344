"""The program's entries, one module each, found by the ``entry`` that a
traffic file names (``portbench/entries/<entry>.py``).

A traffic file is data: the parameters of one mix (chunk length, warm-up,
rows checked, the spans of its layers). The code that drives the program
through one of its entries, makes that entry's draws from the seed, follows
it with the plain reference and compares the two lives in the entry's
module, so a new mix of an existing entry is a data file alone and a new
entry is a module of its own; neither edits a file that is there.

An entry module provides ``NUMBERS``, the names of the numbers its check
reports (a cell's limits name some of them), and ``Run(spec, seed, device,
n_envs, system)``: ``spec`` is ``harness.load_cell``'s, ``n_envs`` overrides
the configuration's batch (tests and size probes), ``system`` is "program"
(the port) or "control" (the reference one precision lower in its place).
A ``Run`` has:

- ``n`` rows a step and ``steps`` steps a chunk: a chunk's work is
  ``n * steps`` env steps;
- ``p``, the configuration as the reference reads it, and
  ``flops_per_env_step``, the work a row's step needs by the yardsticks;
- ``start()``: the set-up's first state, made from the seed;
- ``chunk(c)``: enqueue chunk ``c`` through the program's entry, reading
  nothing back;
- ``check()``: after the window, free the program's state, run the
  reference and return the numbers, a dict keyed by ``NUMBERS``.
"""
