"""Cluster mode. So far only ``replica``: the follower-read vocabulary
(refusal errors, the horaedb_replica_* metric families, and the serving
ContextVars that EXPLAIN and the ledger read). Membership, routing,
forwarding and the coordinator are not ported yet.
"""
