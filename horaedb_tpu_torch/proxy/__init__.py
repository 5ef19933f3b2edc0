"""Protocol front ends in front of the query stack.

So far this package holds ``promql`` (the PromQL parser and evaluator:
``evaluate_range`` over a connection, and the counter chain that reads
live-window state). The ``Proxy`` gateway (workload management, the
slow-query log, hotspots), the HTTP server and the InfluxQL, OpenTSDB
and remote-write front ends of the reference are not ported yet.
"""
