"""GOP-parallel encoding and the multi-host worker controller: the
counterparts of ``handbrake_tpu/parallel``."""
