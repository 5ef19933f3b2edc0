"""Multi-device execution. One card in this slice: ``serving_mesh`` finds
no mesh, and every scan runs on the connection's device."""
