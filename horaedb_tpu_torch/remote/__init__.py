"""Remote engine: the cross-node data path
(ref: src/remote_engine_client/src/client.rs:65-484 and
src/server/src/grpc/remote_engine_service/mod.rs:695-1011).

The reference's DCN backbone is tonic gRPC carrying protobuf envelopes
with arrow-IPC record-batch payloads. Same design here, minus codegen:
gRPC generic handlers (grpcio) with msgpack envelopes + arrow IPC bodies.

- ``codec``    envelope + RowGroup/partial-aggregate (de)serialization
- ``service``  the data node's gRPC server: RemoteEngineService
               (node<->node read/write/partial-agg) + StorageService
               (client-facing SQL/write — the reference's primary
               protocol, grpc/storage_service/mod.rs:55-145)
- ``client``   channel-pooled client + ``RemoteSubTable`` (a Table whose
               owner is another node)
"""

from .client import RemoteEngineClient, RemoteSubTable, grpc_endpoint_for
from .service import GrpcServer

__all__ = ["GrpcServer", "RemoteEngineClient", "RemoteSubTable", "grpc_endpoint_for"]
