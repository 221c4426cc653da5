"""Runtime services of the port: host-offload weight streaming, the
recovery planning and pool re-scatter of elastic replicas, and the hedged
router."""
