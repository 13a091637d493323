"""Step builders of the port's LM (``steps``)."""
