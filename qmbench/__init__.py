"""qmbench: the benchmark of qm_control_tpu_torch on an NVIDIA H100."""
