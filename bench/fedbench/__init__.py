"""The benchmark's harness: the generator of inputs (``traffic``), the
system built from a configuration file (``system``), the offline run of
one window (``drive``), the profiled slice (``profiling``), the
yardstick's arithmetic (``flops``), what readers see (``readers``), the
check against the plain reference (``check``) and one run of a cell
(``cell``)."""
