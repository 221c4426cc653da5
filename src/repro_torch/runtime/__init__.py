"""Runtime services of the port: host-offload weight streaming, and the
recovery planning and pool re-scatter of elastic replicas."""
