"""The LM zoo of the port: configurations, parameters, layers, attention
and the dense-family model (``transformer.LM``)."""
