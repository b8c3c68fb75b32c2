"""Ports of the Llama workloads in ``tpu_operator_libs/examples``."""
