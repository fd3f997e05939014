"""Host utilities of the port (``safepy_tpu/utils``)."""
