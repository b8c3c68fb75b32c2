"""Pod-side health and drain helpers copied from ``tpu_operator_libs/health``."""
