"""Cost analysis of a step: FLOPs, bytes, collectives and peak memory
(``cost``, the port of ``repro.analysis.hlo``)."""
