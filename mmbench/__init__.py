"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

One command runs one cell once::

    python3 -m mmbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, entry route,
cell or metric sits in a file of its own, found by the name that
``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the matrices' shape and blocking;
* ``traffic/<traffic>.json``: the entry route and its parameters;
* ``routes/<route>.py``: how a product enters the program, and what the
  reference must work out again from the same inputs;
* ``workloads/<cell>.json``: the limits of the cell's check;
* ``metrics/<metric>.py``: a reader with ``read(view)``, which returns
  the number or ``None``.

The yardstick lives here too, frozen against later changes to the
program: the case makers (``cases``), the useful-work count and the
table of peaks (``count``), the plain reference and its comparison
(``reference``) and the reduction of the profiler's trace (``trace``).
Nothing here imports ``jax`` or the JAX package ``repro``; the
reference imports nothing of ``repro_torch``.
"""
