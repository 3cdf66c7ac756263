"""The benchmark's shared pieces, one concern a module: the manifest and
the finder of a cell's files (``manifest``), the traffic generator and
the closed loop (``traffic``), the profiler arithmetic (``trace``), the
roofline counts (``roofline``), the result line (``report``), the
imported-module check (``guard``) and one run of a cell (``runner``)."""
