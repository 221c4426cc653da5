"""The paper's analytical multi-MCU model (Siracusa cluster, §II-B and §V):
numpy copies of the JAX package's ``sim/`` modules, with the same names
and the same numbers, reading the configs of ``repro_torch.configs``."""
