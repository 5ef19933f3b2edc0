"""The analytic storage engine (ref: src/analytic_engine).

LSM over object-store Parquet SSTs: columnar memtable -> time-bucketed L0
SSTs -> size/time-window compaction into L1, with a WAL for durability and
a manifest (snapshot + edit log) for metadata. Reads assemble an MVCC view
(memtables + SSTs) and hand dense column buffers to the device scan kernel.
"""
