"""Cost analysis of a step: FLOPs, bytes, collectives and peak memory
(``cost``, the port of ``repro.analysis.hlo``); where a call spends its
time, in spans and counters (``spans``)."""
