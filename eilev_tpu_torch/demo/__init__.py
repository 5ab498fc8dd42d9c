"""The port's interactive demo (counterpart of ``demo/``)."""
