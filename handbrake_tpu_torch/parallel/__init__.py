"""GOP-parallel encoding, several cards in one job (``mesh.py`` on
``torch.distributed``, ``launch.py``) and the multi-host worker
controller: the counterparts of ``handbrake_tpu/parallel``."""
