"""Runtime services of the port: host-offload weight streaming."""
